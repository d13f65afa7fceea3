"""The port's visualization on the CPU, against the JAX package.

``utils/visualization.py``: the lineage graph model (flatten, layers,
barycenter ordering, scaled positions, node boxes, orthogonal routing,
node classes, wire styles, text blocks, hover text), the matplotlib
renderers (``plot_lineage_labview`` with its options, ``Context.plot_lineage``
on each package's default profile), the waveform plots (flat and
structured, channel selectors) and ``create_interactive_browser``, each
fed the same inputs in both packages. ``plot_lineage_plotly`` is compared
where plotly is installed; where it is not, both packages raise
ImportError.

Tolerance: exact everywhere. The graph helpers return the same nodes,
edges, coordinates and routes; a figure has the same number of artists
and titles in each axes and the same x/y data in each line.
"""

import matplotlib

matplotlib.use("Agg")

import importlib.util  # noqa: E402

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from torch_figures import assert_same_figure  # noqa: E402
from waveformanalysis_tpu.context.context import Context as JContext  # noqa: E402
from waveformanalysis_tpu.plugins import plugin_sets as jsets  # noqa: E402
from waveformanalysis_tpu.testing.fixtures import make_fake_st_waveforms  # noqa: E402
from waveformanalysis_tpu.utils import visualization as JV  # noqa: E402
from waveformanalysis_tpu_torch.context.context import Context as TContext  # noqa: E402
from waveformanalysis_tpu_torch.plugins import plugin_sets as tsets  # noqa: E402
from waveformanalysis_tpu_torch.utils import visualization as TV  # noqa: E402


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


def _diamond():
    a = {"plugin_class": "RawFilesPlugin", "plugin_version": "1", "depends_on": {}}
    left = {"plugin_class": "HitFinderPlugin", "plugin_version": "2",
            "config": {"height": 30, "width": 2}, "description": "finds peaks in waveforms",
            "depends_on": {"a": a}}
    right = {"plugin_class": "GroupPlugin", "plugin_version": "2", "depends_on": {"a": a}}
    return {"plugin_class": "DataFramePlugin", "plugin_version": "3",
            "depends_on": {"l": left, "r": right}}


@pytest.fixture(scope="module")
def contexts(tmp_path_factory):
    """Each package's Context under its default profile, with 24 fake
    st_waveforms injected (2 channels, a square pulse, noise)."""
    root = tmp_path_factory.mktemp("viz")
    st = make_fake_st_waveforms(n_events=24, wave_length=64, pulse_start=20, pulse_width=6,
                                pulse_height=250, noise_rms=2.0, seed=4)
    out = {}
    for side, cls, profile, extra in (("jax", JContext, jsets.tpu_default(), {}),
                                      ("port", TContext, tsets.get_profile("cuda"),
                                       {"device": "cpu"})):
        ctx = cls(storage_dir=str(root / side), config={"show_progress": False, **extra})
        ctx.register(*profile)
        ctx.set_config({"hit": {"height": 120.0, "prominence": 40.0}})
        ctx.inject_data("run", "st_waveforms", st)
        out[side] = ctx
    yield out
    for ctx in out.values():
        ctx.flush_saves()


def _lineages(contexts):
    return {"diamond": (_diamond(), _diamond(), "t"),
            "df_paired": (contexts["jax"].get_lineage("df_paired"),
                          contexts["port"].get_lineage("df_paired"), "df_paired"),
            "s1_s2": (contexts["jax"].get_lineage("s1_s2"),
                      contexts["port"].get_lineage("s1_s2"), "s1_s2")}


@pytest.mark.parametrize("case", ["diamond", "df_paired", "s1_s2"])
def test_graph_layout_and_routes_match_jax(contexts, case):
    """lineage_to_graph, layered_layout, order_layers, scaled_positions and
    route_edge on each package's own lineage: the same nodes, edges,
    coordinates and wire paths, exactly."""
    jl, tl, target = _lineages(contexts)[case]
    jn, je, ji = JV.lineage_to_graph(jl, target)
    tn, te, ti = TV.lineage_to_graph(tl, target)
    assert (tn, te) == (jn, je) and len(tn) >= 4
    for n in jn:
        for k in ("plugin_class", "version", "config"):
            assert ti[n][k] == ji[n][k], (n, k)
    by_level = {}
    for n, lvl in JV._levels(jn, je).items():
        by_level.setdefault(lvl, []).append(n)
    assert TV._levels(tn, te) == JV._levels(jn, je)
    for sweeps in (1, 2, 4):
        assert TV.order_layers(by_level, te, sweeps) == JV.order_layers(by_level, je, sweeps)
    jpos, tpos = JV.layered_layout(jn, je), TV.layered_layout(tn, te)
    assert tpos == jpos
    for verbose in (0, 2):
        js, ts = JV.LineageStyle(verbose=verbose), TV.LineageStyle(verbose=verbose)
        jh = {n: JV.estimate_node_height(n, ji[n], js) for n in jn}
        th = {n: TV.estimate_node_height(n, ti[n], ts) for n in tn}
        assert th == jh
        jsp, tsp = JV.scaled_positions(jpos, jh, js), TV.scaled_positions(tpos, th, ts)
        assert tsp == jsp
        jb, tb = JV._node_boxes(jsp, jh, js), TV._node_boxes(tsp, th, ts)
        assert tb == jb
        W = js.node_width
        for src, dst in je:
            start = (jsp[src][0] + W / 2, jsp[src][1])
            end = (jsp[dst][0] - W / 2, jsp[dst][1])
            assert TV.route_edge(start, end, tb, {src, dst}) == \
                JV.route_edge(start, end, jb, {src, dst})
    for n in jn:
        assert TV.classify_node_type(n, ti[n]) == JV.classify_node_type(n, ji[n])
        assert TV.upstream_nodes(te, n) == JV.upstream_nodes(je, n)


def test_route_edge_cases_match_jax():
    wall = [{"id": f"w{i}", "x_min": 0.05 + 0.39 * i, "x_max": 0.44 + 0.39 * i,
             "y_min": -50, "y_max": 50} for i in range(10)]
    mid = [{"id": "mid", "x_min": 1.5, "x_max": 2.5, "y_min": -0.5, "y_max": 0.5}]
    band = [{"id": "band", "x_min": 0.5, "x_max": 3.5, "y_min": -2.0, "y_max": 2.0}]
    for boxes in ([], mid, band, wall):
        for end in ((4.0, 0.0), (4.0, 2.0), (4.0, -3.0)):
            assert TV.route_edge((0.0, 0.0), end, boxes, set()) == \
                JV.route_edge((0.0, 0.0), end, boxes, set())
    assert TV.route_edge((0.0, 0.0), (4.0, 0.0), wall, set()) is None


def test_text_styles_and_selectors_match_jax():
    details = {"plugin_class": "HitFinderPlugin", "version": "2.0.0",
               "description": "finds peaks in baseline-subtracted waveforms " * 3,
               "dtype": "[('time', '<i8'), ('area', '<f4')]",
               "config": {f"opt{i}": i * 1.5 for i in range(9)}}
    for verbose in (0, 1, 2, 3):
        js, ts = JV.LineageStyle(verbose=verbose), TV.LineageStyle(verbose=verbose)
        assert TV.node_text_lines("hit", details, ts) == JV.node_text_lines("hit", details, js)
        assert TV.format_node_info("hit", details, verbose) == \
            JV.format_node_info("hit", details, verbose)
    for width, lines in ((8, None), (12, 2), (30, 1)):
        assert TV.wrap_text_lines(details["description"], width, lines) == \
            JV.wrap_text_lines(details["description"], width, lines)
    style = dict(wire_style_overrides={"hit": {"color": "#000000", "dash": "dot"}})
    for dtype in ("", "DataFrame", "list of ndarray", "[('a', '<i4')]", "ndarray", "weird"):
        assert TV.classify_edge_category(dtype) == JV.classify_edge_category(dtype)
        assert TV.resolve_wire_style("hit", "df", dtype, TV.LineageStyle(**style)) == \
            JV.resolve_wire_style("hit", "df", dtype, JV.LineageStyle(**style))
    for sel in ((1, 3), "b2c5", "0:7", "ch4", 6, np.int16(2)):
        assert TV._parse_channel_selector(sel) == JV._parse_channel_selector(sel)
    from waveformanalysis_tpu.hardware import HardwareChannel as JHC
    from waveformanalysis_tpu_torch.hardware import HardwareChannel as THC

    assert TV._parse_channel_selector(THC(1, 2)) == JV._parse_channel_selector(JHC(1, 2))
    with pytest.raises(ValueError, match="unrecognized"):
        TV._parse_channel_selector(1.5)


class _Analysis:
    critical_path = ["a", "l", "t"]
    bottlenecks = [("r", 0.9)]
    parallel_groups = [["l", "r"]]


@pytest.mark.parametrize("kwargs", [
    {}, {"verbose": 2}, {"verbose": 1, "style": "legend"},
    {"analysis_result": _Analysis(), "highlight_critical_path": True,
     "highlight_bottlenecks": True, "highlight_parallel_groups": True},
    {"style": "arcs"}, {"interactive": True},
])
def test_plot_lineage_labview_matches_jax(kwargs):
    def run(mod):
        kw = dict(kwargs)
        if kw.get("style") == "legend":
            kw["style"] = mod.LineageStyle(show_legend=True)
        elif kw.get("style") == "arcs":
            kw["style"] = mod.LineageStyle(orthogonal_wires=False, show_ports=False)
        return mod.plot_lineage_labview(_diamond(), "t", **kw)

    ref, got = run(JV), run(TV)
    assert_same_figure(ref, got, str(kwargs))
    assert [p.get_facecolor() for p in got.patches] == [p.get_facecolor() for p in ref.patches]
    assert [t.get_text() for t in got.texts] == [t.get_text() for t in ref.texts]
    if kwargs.get("interactive"):
        on_hover, on_click, annot = got._wfa_interactive

        class Ev:
            inaxes = got
            xdata, ydata = 0.0, 0.0

        on_hover(Ev())
        on_click(Ev())
        assert annot.get_visible() is not None


@pytest.mark.parametrize("target", ["df_paired", "hit"])
def test_context_plot_lineage_matches_jax(contexts, target):
    """Context.plot_lineage on each package's default profile: the same
    boxes, wires and labels (the port's kernel-backend options differ in
    help text only, which the plot does not show)."""
    ref = contexts["jax"].plot_lineage(target, verbose=2)
    got = contexts["port"].plot_lineage(target, verbose=2)
    assert_same_figure(ref, got, target)
    assert [t.get_text() for t in got.texts] == [t.get_text() for t in ref.texts]
    with pytest.raises(ValueError, match="unknown renderer"):
        contexts["port"].plot_lineage(target, renderer="svg")


def test_plot_lineage_plotly_matches_jax(contexts):
    """Where plotly is installed, the same traces and shapes; where it is
    not, both packages raise ImportError (plotly is imported lazily)."""
    if importlib.util.find_spec("plotly") is None:
        for ctx in contexts.values():
            with pytest.raises(ImportError):
                ctx.plot_lineage("s1_s2", renderer="plotly")
        return
    ref = contexts["jax"].plot_lineage("s1_s2", renderer="plotly")
    got = contexts["port"].plot_lineage("s1_s2", renderer="plotly")
    assert [(t.x, t.y) for t in got.data] == [(t.x, t.y) for t in ref.data]
    assert len(got.layout.shapes) == len(ref.layout.shapes)


def test_plot_waveforms_match_jax(contexts):
    rng = np.random.default_rng(0)
    waves = 1000 + rng.normal(0, 3, (10, 64))
    for kwargs in ({}, {"baselines": np.full(10, 1000.0), "hits": {"position": np.array([10, 30])}},
                   {"max_events": 3}):
        assert_same_figure(JV.plot_waveforms(waves, **kwargs),
                           TV.plot_waveforms(waves, **kwargs), str(kwargs))
    st = make_fake_st_waveforms(n_events=24, wave_length=64, pulse_start=20, pulse_width=6,
                                pulse_height=250, noise_rms=2.0, seed=4)
    hits = {side: ctx.get_data("run", "hit") for side, ctx in contexts.items()}
    for kwargs in ({"event_index": 2}, {"event_index": 50}, {"channels": ["b0c1", (0, 0)]},
                   {"event_index": 0, "title": "T"}):
        assert_same_figure(JV.plot_waveforms(st, hits=hits["jax"], **kwargs),
                           TV.plot_waveforms(st, hits=hits["port"], **kwargs), str(kwargs))


def test_interactive_browser_matches_jax(contexts):
    browsers = {side: mod.create_interactive_browser(contexts[side], "run")
                for side, mod in (("jax", JV), ("port", TV))}
    for i in (0, 5):
        assert_same_figure(browsers["jax"](i), browsers["port"](i), f"event {i}")


def test_interactive_browser_without_hit(tmp_path):
    """No hit plugin registered: the browser draws the waves alone."""
    st = make_fake_st_waveforms(n_events=6, wave_length=32, seed=1)
    figs = []
    for cls, mod, extra in ((JContext, JV, {}), (TContext, TV, {"device": "cpu"})):
        ctx = cls(storage_dir=str(tmp_path / mod.__name__), config={"show_progress": False,
                                                                     **extra})
        ctx.inject_data("r", "st_waveforms", st)
        figs.append(mod.create_interactive_browser(ctx, "r")(1))
    assert_same_figure(*figs, "no hit")
