"""The port's plugin tools on the CPU, against the JAX package.

``plugins/adapters.py`` (strax options and dtypes both ways, a wrapped
strax-style plugin computing through a Context, its lineage key, the
``StraxContextAdapter`` facade), ``plugins/loader.py`` (directory, module
and entry-point discovery, the failure report, a class of the JAX
package's Plugin refused) and ``plugins/hot_reload.py`` (change detection,
re-registration, cache invalidation, the background poll). Each case runs
the same inputs through both packages, with each package's own Plugin
base where a plugin is defined, and compares the results.

Tolerance: every compared value exactly (integers, float32 arrays made
from the same integers, keys, strings); the strax plugin's float32 areas
are ``amp * 2.0`` of small integers, exact in both.
"""

import textwrap
import time
from importlib import metadata

import numpy as np
import pytest

from waveformanalysis_tpu.context import fusion as jfusion
from waveformanalysis_tpu.context.context import Context as JContext
from waveformanalysis_tpu.plugins import adapters as JA
from waveformanalysis_tpu.plugins import hot_reload as JH
from waveformanalysis_tpu.plugins import loader as JL
from waveformanalysis_tpu.plugins.base import Plugin as JPlugin
from waveformanalysis_tpu.testing.fixtures import make_fake_st_waveforms
from waveformanalysis_tpu_torch.context.context import Context as TContext
from waveformanalysis_tpu_torch.plugins import adapters as TA
from waveformanalysis_tpu_torch.plugins import hot_reload as TH
from waveformanalysis_tpu_torch.plugins import loader as TL
from waveformanalysis_tpu_torch.plugins.base import Plugin as TPlugin


class FakeStraxOption:
    """Minimal strax.Option look-alike."""

    def __init__(self, name, default=None, help="", type=None):
        self.name = name
        self.default = default
        self.help = help
        self.type = type


class FakeStraxPlugin:
    """Minimal strax.Plugin look-alike (duck-typed attributes)."""

    provides = "strax_peaks"
    depends_on = ("strax_records",)
    __version__ = "2.1.0"
    save_when = 3  # strax SaveWhen.ALWAYS
    dtype = [("time", np.int64), ("area", np.float32), ("channel", np.int16)]
    takes_config = {
        "threshold": FakeStraxOption("threshold", default=5.0, help="cut", type=float),
    }

    def compute(self, records):
        out = np.zeros(len(records), dtype=self.dtype)
        out["time"] = records["time"]
        out["area"] = records["amp"] * 2.0
        out["channel"] = records["channel"]
        return out


PACKAGES = {
    "jax": ("waveformanalysis_tpu", JContext, JA, JL, JH, JPlugin),
    "port": ("waveformanalysis_tpu_torch", TContext, TA, TL, TH, TPlugin),
}


def _context(side, path):
    config = {"show_progress": False}
    if side == "port":
        config["device"] = "cpu"
    return PACKAGES[side][1](storage_dir=str(path), config=config)


def _records_source(base):
    class RecordsSource(base):
        provides = "strax_records"
        save_when = "never"

        def compute(self, context, run_id, **kwargs):
            n = 8
            out = np.zeros(n, dtype=[("time", np.int64), ("amp", np.float32),
                                     ("channel", np.int16)])
            out["time"] = np.arange(n) * 10
            out["amp"] = np.arange(n, dtype=np.float32)
            out["channel"] = np.arange(n) % 2
            return out

    return RecordsSource


def _strax_context(side, path):
    _pkg, _ctx, adapters, _l, _h, base = PACKAGES[side]
    ctx = _context(side, path)
    ctx.register(_records_source(base)(), adapters.wrap_strax_plugin(FakeStraxPlugin))
    return ctx


class TitledStraxPlugin(FakeStraxPlugin):
    """A strax plugin with titled dtype tuples, a list of options and
    provides/depends_on as lists."""

    provides = ["strax_titled"]
    depends_on = "strax_records"
    __version__ = None
    version = "0.3.1"
    save_when = type("SaveWhen", (), {"name": "TARGET"})()
    dtype = [(("Peak time", "time"), np.int64), (("Peak area", "area"), np.float32),
             (("Channel", "channel"), np.int16)]
    takes_config = (
        FakeStraxOption("threshold", default=5.0, help="cut", type=float),
        FakeStraxOption("label", default="x", help="a name", type="not-a-type"),
    )


@pytest.mark.parametrize("dtype_like", [
    np.dtype([("time", "<i8"), ("area", "<f4"), ("tag", "U4")]),
    np.dtype([("wave", "<i2", (16,)), ("baseline", "<f8")]),
    FakeStraxPlugin.dtype,
])
def test_dtype_conversion_matches_jax(dtype_like):
    ref = JA.convert_dtype_to_strax(dtype_like)
    assert TA.convert_dtype_to_strax(dtype_like) == ref
    assert TA.convert_dtype_from_strax(ref) == JA.convert_dtype_from_strax(ref)
    assert TA.convert_dtype_from_strax(TitledStraxPlugin.dtype) == \
        JA.convert_dtype_from_strax(TitledStraxPlugin.dtype)


def test_schema_to_strax_matches_jax():
    from waveformanalysis_tpu.dtypes.schema import ST_WAVEFORM_SCHEMA as JS
    from waveformanalysis_tpu_torch.dtypes.schema import ST_WAVEFORM_SCHEMA as TS

    assert TA.convert_dtype_to_strax(TS) == JA.convert_dtype_to_strax(JS)


@pytest.mark.parametrize("strax_cls", [FakeStraxPlugin, TitledStraxPlugin])
def test_wrapped_plugin_attributes_and_options_match_jax(strax_cls):
    ref, got = JA.wrap_strax_plugin(strax_cls), TA.wrap_strax_plugin(strax_cls())
    assert isinstance(got, TA.StraxPluginAdapter) and isinstance(got, TPlugin)
    for attr in ("provides", "depends_on", "version", "description", "save_when",
                 "output_dtype"):
        assert getattr(got, attr) == getattr(ref, attr), attr
    assert list(got.options) == list(ref.options)
    for name, opt in ref.options.items():
        mine = got.options[name]
        for field in ("default", "type", "help", "track"):
            assert getattr(mine, field) == getattr(opt, field), (name, field)


def test_wrapped_plugin_computes_and_keys_as_jax(tmp_path):
    """The wrapped strax plugin's output through each Context, and its
    lineage key: the converted options (their help strings among them)
    hash into the same key in both packages."""
    out = {}
    for side in PACKAGES:
        ctx = _strax_context(side, tmp_path / side)
        arr = ctx.get_data("r", "strax_peaks")
        arr = arr.to_numpy() if hasattr(arr, "to_numpy") else np.asarray(arr)
        out[side] = (arr, ctx.key_for("r", "strax_peaks"), ctx.get_lineage("strax_peaks"))
        ctx.set_config({"strax_peaks": {"threshold": 6.0}})
        out[side] += (ctx.key_for("r", "strax_peaks"),)
    (ra, rk, rl, rk6), (ga, gk, gl, gk6) = out["jax"], out["port"]
    assert ga.dtype == ra.dtype and np.array_equal(ga, ra)
    np.testing.assert_array_equal(ga["area"], np.arange(8, dtype=np.float32) * 2.0)
    assert gk == rk and gl == rl
    assert gk6 == rk6 != gk


def test_strax_context_adapter_matches_jax(tmp_path):
    facades = {side: TA.StraxContextAdapter(_strax_context(side, tmp_path / side))
               if side == "port" else JA.StraxContextAdapter(_strax_context(side, tmp_path / side))
               for side in PACKAGES}
    ref, got = facades["jax"], facades["port"]
    a, b = ref.get_array("r", "strax_peaks"), got.get_array("r", "strax_peaks")
    assert isinstance(b, np.ndarray) and b.dtype == a.dtype and np.array_equal(a, b)
    import pandas as pd

    pd.testing.assert_frame_equal(got.get_df("r", "strax_peaks"), ref.get_df("r", "strax_peaks"))
    for pattern in ("area", "time", "nonexistent_xyz"):
        assert got.search_field(pattern) == ref.search_field(pattern)
    assert got.key_for("r", "strax_peaks") == ref.key_for("r", "strax_peaks")
    # register() wraps strax classes and passes the package's own plugins
    got.register(TitledStraxPlugin)
    ref.register(TitledStraxPlugin)
    assert got.ctx.get_plugin("strax_titled").save_when == "target"
    np.testing.assert_array_equal(got.get_array("r", "strax_titled"),
                                  ref.get_array("r", "strax_titled"))


PLUGIN_FILE = textwrap.dedent('''
    import numpy as np
    from {pkg}.plugins.base import Plugin

    class CustomPlugin(Plugin):
        provides = "custom_data"
        version = "{version}"

        def compute(self, context, run_id, **kwargs):
            out = np.zeros(4, dtype=[("v", "i4")])
            out["v"] = {value}
            return out

    class _Helper:
        pass
''')


def _write_plugin(path, pkg, version="1.0.0", value=1):
    path.write_text(PLUGIN_FILE.format(pkg=pkg, version=version, value=value))


def test_directory_discovery_matches_jax(tmp_path):
    """The same directory scan in each package: one plugin found, the
    broken file and a missing directory in the report, the summary's
    lines, and register_discovered."""
    results = {}
    for side, (pkg, _c, _a, loader, _h, _b) in PACKAGES.items():
        d = tmp_path / side / "plugins"
        d.mkdir(parents=True)
        _write_plugin(d / "my_plugin.py", pkg)
        (d / "broken.py").write_text("this is not python ][")
        (d / "_private.py").write_text("raise RuntimeError('never imported')")
        ldr = loader.PluginLoader()
        found = ldr.discover_directory(d)
        ldr.discover_directory(tmp_path / side / "nope")
        ctx = _context(side, tmp_path / side / "store")
        n = ldr.register_discovered(ctx)
        results[side] = ([c.provides for c in found], n,
                         [f.source.rsplit("/", 1)[-1] for f in ldr.report.failures],
                         ldr.report.summary().splitlines()[0],
                         ctx.get_data("r", "custom_data")["v"].tolist())
    assert results["port"] == results["jax"]
    assert results["port"][0] == ["custom_data"] and results["port"][1] == 1


def test_module_discovery_matches_jax():
    for pkg in ("builtin.peak_finding", "builtin.basic_features"):
        ref = JL.PluginLoader().discover_module(f"waveformanalysis_tpu.plugins.{pkg}")
        got = TL.PluginLoader().discover_module(f"waveformanalysis_tpu_torch.plugins.{pkg}")
        assert sorted(c.__name__ for c in got) == sorted(c.__name__ for c in ref)
        assert all(issubclass(c, TPlugin) for c in got)
    ldr = TL.PluginLoader()
    assert ldr.discover_module("no_such_module_xyz") == []
    assert ldr.report.failures[0].source == "no_such_module_xyz"


def test_a_jax_plugin_is_a_load_failure(tmp_path):
    """The port loads only subclasses of its own Plugin: a file of the JAX
    package's plugins loads none, and each plugin-like class is reported."""
    _write_plugin(tmp_path / "jax_plugin.py", "waveformanalysis_tpu")
    ldr = TL.PluginLoader()
    assert ldr.discover_directory(tmp_path) == []
    (failure,) = ldr.report.failures
    assert failure.source.endswith("jax_plugin.py")
    assert "CustomPlugin is not a subclass of waveformanalysis_tpu_torch.plugins.base.Plugin" \
        in failure.error
    # an entry point that loads a JAX plugin class, not a port one
    ldr = TL.PluginLoader()
    assert ldr._collect_plugin_classes(FakeJaxPlugin, "ep") == []
    assert [f.source for f in ldr.report.failures] == ["ep"]
    # the JAX package's loader takes that file's class
    assert [c.provides for c in JL.PluginLoader().discover_directory(tmp_path)] == ["custom_data"]


class FakeJaxPlugin(JPlugin):
    provides = "jax_only"

    def compute(self, context, run_id, **kwargs):
        return np.zeros(1)


class _EntryPoint:
    def __init__(self, name, obj):
        self.name, self.obj = name, obj

    def load(self):
        if isinstance(self.obj, Exception):
            raise self.obj
        return self.obj

    def __str__(self):
        return f"EntryPoint({self.name})"


def test_entry_points_read_the_port_groups(monkeypatch):
    """The port reads its own group and the reference's, never the JAX
    package's; a port plugin loads, a JAX plugin and a failing entry point
    are reported."""
    from waveformanalysis_tpu_torch.plugins.builtin.basic_features import BasicFeaturesPlugin

    asked = []
    groups = {
        "waveformanalysis_tpu_torch.plugins": [_EntryPoint("ok", BasicFeaturesPlugin),
                                               _EntryPoint("jax", FakeJaxPlugin)],
        "waveform_analysis.plugins": [_EntryPoint("bad", ImportError("no such plugin"))],
        "waveformanalysis_tpu.plugins": [_EntryPoint("never", BasicFeaturesPlugin)],
    }

    def entry_points(group):
        asked.append(group)
        return groups.get(group, [])

    monkeypatch.setattr(metadata, "entry_points", entry_points)
    assert TL.ENTRY_POINT_GROUPS == ("waveformanalysis_tpu_torch.plugins",
                                     "waveform_analysis.plugins")
    ldr = TL.PluginLoader()
    report = ldr.discover_all()
    assert asked == list(TL.ENTRY_POINT_GROUPS)
    assert report.plugins == [BasicFeaturesPlugin]
    assert [f.source for f in report.failures] == ["EntryPoint(jax)", "EntryPoint(bad)"]
    assert "no such plugin" in report.failures[1].error


def _touch(path, text):
    time.sleep(0.02)  # mtime granularity: both mtime and content change
    path.write_text(text)


def test_hot_reload_matches_jax(tmp_path):
    """A plugin loaded from a file, edited: each package's reloader sees
    the change, re-registers the new class, invalidates its cache (the
    next get_data recomputes under the new version's key), ignores an
    unchanged file and survives a broken edit."""
    got = {}
    for side, (pkg, _c, _a, loader, hot, _b) in PACKAGES.items():
        d = tmp_path / side
        d.mkdir()
        src = d / f"hot_{side}_mod.py"
        _write_plugin(src, pkg)
        ctx = _context(side, d / "store")
        (cls,) = loader.PluginLoader().discover_directory(d)
        ctx.register(cls())
        r = hot.enable_hot_reload(ctx)
        first = ctx.get_data("r", "custom_data")["v"].tolist()
        key1 = ctx.key_for("r", "custom_data")
        unchanged = (r.changed_modules(), r.check_and_reload())
        _touch(src, PLUGIN_FILE.format(pkg=pkg, version="2.0.0", value=2))
        changed = [m.startswith(f"_wfa_plugin_{src.stem}_") for m in r.changed_modules()]
        reloaded = r.check_and_reload()
        second = ctx.get_data("r", "custom_data")["v"].tolist()
        key2 = ctx.key_for("r", "custom_data")
        _touch(src, "raise RuntimeError('bad edit')\n" + src.read_text())
        broken = r.check_and_reload()
        got[side] = (first, unchanged, changed, reloaded, second, r.reload_count,
                     ctx.get_plugin("custom_data").version, key1 != key2, broken)
    assert got["port"] == got["jax"]
    assert got["port"][4] == [2, 2, 2, 2] and got["port"][5] == 1


def test_background_reload_thread_starts_and_stops(tmp_path):
    src = tmp_path / "bg_mod.py"
    _write_plugin(src, "waveformanalysis_tpu_torch")
    ctx = _context("port", tmp_path / "store")
    (cls,) = TL.PluginLoader().discover_directory(tmp_path)
    ctx.register(cls())
    r = TH.enable_hot_reload(ctx, interval_s=0.02, background=True)
    try:
        assert r._thread is not None and r._thread.is_alive()
        _touch(src, PLUGIN_FILE.format(pkg="waveformanalysis_tpu_torch", version="3.0.0",
                                       value=3))
        deadline = time.time() + 10
        while r.reload_count == 0 and time.time() < deadline:
            time.sleep(0.02)
        assert ctx.get_plugin("custom_data").version == "3.0.0"
    finally:
        r.stop()
    assert r._thread is None


FUSED_HIT_FILE = textwrap.dedent('''
    from {pkg}.plugins.builtin.peak_finding import HitFinderPlugin


    class HotHit(HitFinderPlugin):
        """hit with a scaled device stage"""

        version = "{version}"

        @staticmethod
        def device_stage(cfg, waves_d, lengths_d, sign_d, baselines_d):
            out = dict(HitFinderPlugin.device_stage(cfg, waves_d, lengths_d, sign_d,
                                                    baselines_d))
            out["peak_heights"] = out["peak_heights"] * {scale}
            return out
''')


def test_hot_reloaded_fused_member_device_stage(tmp_path):
    """A fused member (a hit subclass whose compute is the builtin one)
    reloaded with a new device_stage and a new version. Run "a" computed
    hit and basic_features in one fused program before the reload; after
    it, run "a" recomputes hit alone (basic_features is cached), and a
    fresh run "b" computes both fused again. Both packages run the new
    stage on the standalone path. On the fused path the port runs it too,
    since its fused executor reads each member's stage from its class at
    every dispatch; the JAX package runs the program it built first for
    the same members and config (``WaveChainFusion._get_program``'s cache
    is keyed on members and config values, not on the stage), so its
    heights stay unscaled there. A deliberate divergence (ROADMAP Queue
    3)."""
    st = make_fake_st_waveforms(n_events=24, wave_length=64, pulse_start=20, pulse_width=6,
                                pulse_height=250, noise_rms=2.0, seed=3)
    both = ["hit", "basic_features"]
    heights = {}
    for side, (pkg, _c, _a, loader, hot, _b) in PACKAGES.items():
        if side == "jax":  # a fresh program cache, as a fresh process has
            rule = jfusion.get_fusion_rules()[0]
            saved, rule._programs = rule._programs, {}
        d = tmp_path / side
        d.mkdir()
        src = d / f"fused_{side}_mod.py"
        src.write_text(FUSED_HIT_FILE.format(pkg=pkg, version="3.3.1", scale=1.0))
        ctx = _context(side, d / "store")
        bf = __import__(f"{pkg}.plugins.builtin.basic_features",
                        fromlist=["BasicFeaturesPlugin"]).BasicFeaturesPlugin
        (cls,) = [c for c in loader.PluginLoader().discover_directory(d)
                  if c.__name__ == "HotHit"]
        ctx.register(cls(), bf())
        ctx.set_config({"hit": {"use_derivative": False, "height": 80.0, "prominence": 50.0}})
        for run in ("a", "b"):
            ctx.inject_data(run, "st_waveforms", st)
        r = hot.enable_hot_reload(ctx)
        before = np.asarray(ctx.get_data("a", both)["hit"]["height"])
        _touch(src, FUSED_HIT_FILE.format(pkg=pkg, version="3.3.2", scale=2.0))
        assert r.check_and_reload() == ["hit"]
        alone = np.asarray(ctx.get_data("a", both)["hit"]["height"])
        fused = np.asarray(ctx.get_data("b", both)["hit"]["height"])
        if side == "jax":
            rule._programs = saved
        heights[side] = (before, alone, fused)
    (jb, ja, jf), (tb, ta, tf) = heights["jax"], heights["port"]
    assert len(tb) > 0 and np.array_equal(tb, jb)
    np.testing.assert_array_equal(ja, jb * 2)  # standalone: the reloaded stage
    np.testing.assert_array_equal(ta, tb * 2)
    np.testing.assert_array_equal(jf, jb)  # JAX fused: the first program's stage
    np.testing.assert_array_equal(tf, tb * 2)  # the port fused: the reloaded stage
