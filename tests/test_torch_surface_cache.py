"""The port's cache suite, export, lineage and docs against the JAX package's.

One synthetic VX2730 run (tests/utils.py create_daq_run) goes through a
CPU Context of each package (profile ``cpu``, ``get_data(run,
["df_paired", "hit_grouped", "s1_s2"])``). On those storages: the
analyzer's per-name entry counts and sizes, the summaries, the diagnostics,
a planted truncated ``.bin``, every clean policy (age, size budget,
version, integrity, ``--all``, dry run) and ``waveform-cache``'s JSON give
the same answers as the JAX package's, entry for entry by data name (keys
differ: the port folds each plugin's kernel_version into its lineage). One
repair is pinned: the fused program's capacity hints are no orphans in the
port. Also: ``CacheManager``; ``DataExporter`` on one Table, every format
read back equal (floats within atol 1e-3 / rtol 1e-4, the rest exactly);
``analyze_dependencies`` and ``build_lineage_graph`` (nodes, edges,
critical path, parallel groups); ``waveform-docs`` pages and coverage;
``DAQRun`` / ``DAQAnalyzer``; the cache-analysis plugin and helpers.
"""

import contextlib
import io
import json
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

import waveformanalysis_tpu as jwa
import waveformanalysis_tpu_torch as wa
from utils import create_daq_run
from waveformanalysis_tpu.storage import cache_ops as jops
from waveformanalysis_tpu_torch.storage import cache_ops as tops
from waveformanalysis_tpu_torch.storage.memmap import STORAGE_VERSION

ATOL, RTOL = 1e-3, 1e-4
RUN = "run_c"
REQUEST = ["df_paired", "hit_grouped", "s1_s2"]
HINT = tops.HINT_SUFFIX


def daq_config(daq) -> dict:
    return {"data_root": str(daq / "DAQ"), "daq_adapter": "vx2730", "n_channels": 2,
            "show_progress": False}


def make_contexts(daq, root, jax_dir="jax", port_dir="port"):
    from waveformanalysis_tpu.plugins.plugin_sets import get_profile as jax_profile

    j = jwa.Context(storage_dir=str(root / jax_dir), config=daq_config(daq))
    j.register(*jax_profile("cpu"))
    t = wa.Context(storage_dir=str(root / port_dir), config=dict(daq_config(daq), device="cpu"))
    t.register(*wa.get_profile("cpu"))
    return j, t


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """Both packages' storages after the same request on the same run."""
    root = tmp_path_factory.mktemp("surface")
    create_daq_run(root / "DAQ", RUN, n_channels=2, n_rows=16, n_samples=48,
                   pulse_height=-300)
    j, t = make_contexts(root, root)
    for ctx in (j, t):
        ctx.get_data(RUN, REQUEST)
        ctx.flush_saves()
    return root, j, t


@pytest.fixture()
def copies(stores, tmp_path):
    """Writable copies of both storages: (jax MemmapStorage, port's)."""
    root = stores[0]
    for tag in ("jax", "port"):
        shutil.copytree(root / tag, tmp_path / tag)
    return (jwa.MemmapStorage(str(tmp_path / "jax")), wa.MemmapStorage(str(tmp_path / "port")))


def name_of(key: str) -> str:
    """A cache key's data name; a capacity hint keeps its suffix, not the
    lineage hash that differs between the packages."""
    if key.endswith(HINT):
        return tops._data_name_from_key(key[: -len(HINT)], RUN) + HINT
    return tops._data_name_from_key(key, RUN)


def by_name(stats: dict) -> dict:
    """by_data_type with a hint's name ("{name}-{hash8}", the analyzer's)
    as name_of gives it."""
    return {k.rsplit("-", 1)[0] + HINT if "-" in k else k: v
            for k, v in stats["by_data_type"].items()}


def test_analyzer_equals_jax_by_data_name(stores):
    _, j, t = stores
    ja, ta = jops.CacheAnalyzer(j.storage), tops.CacheAnalyzer(t.storage)
    js, ts = ja.statistics().to_dict(), ta.statistics().to_dict()
    assert by_name(ts) == by_name(js)
    assert len(by_name(ts)) == len(ts["by_data_type"]) and f"hit_threshold{HINT}" in by_name(ts)
    assert {k: ts[k] for k in ("total_runs", "total_entries", "total_size_bytes")} == \
        {k: js[k] for k in ("total_runs", "total_entries", "total_size_bytes")}
    assert ts["total_entries"] > 10 and ts["total_size_bytes"] > 0
    for f in ("n_entries", "total_bytes", "by_run_bytes"):
        assert ta.summary(RUN)[f] == ja.summary(RUN)[f]
    rows = lambda a: sorted((name_of(e.key), e.size_bytes, e.n_rows, e.has_lineage,  # noqa: E731
                             e.plugin_class, e.storage_version) for e in a.scan(RUN))
    assert rows(ta) == rows(ja)
    assert ta.list_runs() == ja.list_runs() == [RUN]
    assert ta.report(RUN).splitlines()[0] == ja.report(RUN).splitlines()[0]


def test_diagnostics_hint_repair(stores):
    """The same report, except that the capacity hints the fused program
    wrote are orphan metadata in the JAX package and healthy in the port."""
    _, j, t = stores
    jr = jops.CacheDiagnostics(j.storage).diagnose()
    tr = tops.CacheDiagnostics(t.storage).diagnose()
    assert [name_of(k) for k in jr["orphan_metadata"]] == [f"hit_threshold{HINT}"]
    assert not jr["is_healthy"]
    assert tr == dict(jr, orphan_metadata=[], is_healthy=True)
    assert t.diagnose_cache(RUN) == tr
    assert t.analyze_cache(RUN)["summary"]["n_entries"] == \
        j.analyze_cache(RUN)["summary"]["n_entries"]


def test_truncated_bin_is_found_and_cleaned(copies):
    for ops, storage in zip((jops, tops), copies):
        key = next(k for k in storage.list_keys(RUN) if name_of(k) == "st_waveforms")
        path = storage._bin_path(key, RUN)
        path.write_bytes(path.read_bytes()[:100])
        report = ops.CacheDiagnostics(storage).diagnose(RUN)
        assert report["corrupt"] == [key] and not report["is_healthy"]
        cleaner = ops.CacheCleaner(storage)
        plan = cleaner.plan(run_id=RUN, failed_integrity=True)
        assert [e.key for e in plan.to_delete] == [key]
        assert cleaner.execute(plan) == 1 and not storage.exists(key, RUN)


@pytest.mark.parametrize("policy", [
    {"max_age_s": 0.0},
    {"max_age_s": 1e9},
    {"max_total_bytes": 5000, "strategy": "largest"},
    {"storage_version": "0.0"},
    {"storage_version": STORAGE_VERSION},
    {"data_name": "df_events"},
    {"max_age_s": 0.0, "keep_recent_s": 1e9},
], ids=["age_all", "age_none", "budget_largest", "version_other", "version_same",
        "data_name", "keep_recent"])
def test_clean_plans_equal_jax(copies, policy):
    """The same data names selected; a dry run deletes nothing, a run
    deletes exactly the plan."""
    plans = []
    for ops, storage in zip((jops, tops), copies):
        cleaner = ops.CacheCleaner(storage)
        plan = cleaner.plan(run_id=RUN, **policy)
        plans.append(sorted(name_of(e.key) for e in plan.to_delete))
        before = len(storage.list_keys(RUN))
        assert cleaner.execute(plan, dry_run=True) == len(plan.to_delete)
        assert len(storage.list_keys(RUN)) == before
        assert cleaner.execute(plan) == len(plan.to_delete)
        assert len(storage.list_keys(RUN)) == before - len(plan.to_delete)
    assert plans[1] == plans[0]


def cache_cli(main, storage_dir, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["--storage-dir", str(storage_dir), *args])
    return rc, out.getvalue()


@pytest.mark.parametrize("command", ["info", "stats", "list", "diagnose"])
def test_cache_cli_json_equals_jax(copies, command):
    from waveformanalysis_tpu.cli_cache import main as jax_main
    from waveformanalysis_tpu_torch.cli_cache import main as port_main

    (jrc, jout), (trc, tout) = (cache_cli(m, s.work_dir, command, "--json")
                                for m, s in zip((jax_main, port_main), copies))
    want, got = json.loads(jout), json.loads(tout)
    if command == "list":
        strip = lambda es: sorted((name_of(e["key"]), e["size_bytes"], e["n_rows"])  # noqa: E731
                                  for e in es)
        assert strip(got) == strip(want)
    elif command == "diagnose":  # the hint repair: healthy, exit 0
        assert (jrc, trc) == (1, 0)
        assert got == dict(want, orphan_metadata=[], is_healthy=True)
    else:
        assert trc == jrc == 0
        assert {k: got[k] for k in ("n_entries", "total_bytes", "by_run_bytes")} == \
            {k: want[k] for k in ("n_entries", "total_bytes", "by_run_bytes")}


@pytest.mark.parametrize("args", [
    ["clean", "--all", "--dry-run"],
    ["clean", "--max-age-hours", "0", "--dry-run"],
    ["clean", "--storage-version", "0.0", "--yes"],
    ["clean", "--failed-integrity", "--yes"],
    ["clean", "--max-total-mb", "0", "--yes"],
    ["clean", "--yes"],
], ids=["all_dry", "age_dry", "version", "integrity", "budget", "no_policy"])
def test_cache_cli_clean_equals_jax(copies, args):
    from waveformanalysis_tpu.cli_cache import main as jax_main
    from waveformanalysis_tpu_torch.cli_cache import main as port_main

    results = []
    for main, storage in zip((jax_main, port_main), copies):
        before = len(storage.list_keys(RUN))
        with contextlib.redirect_stderr(io.StringIO()):
            rc, out = cache_cli(main, storage.work_dir, "--run-name", RUN, *args)
        lines = out.splitlines()
        results.append((rc, lines[:1], lines[-1:] if "--yes" in args else [],
                        before - len(storage.list_keys(RUN))))
        if "--dry-run" in args:
            assert results[-1][3] == 0
    assert results[1] == results[0]


def test_cache_tools_and_plugin(stores):
    from waveformanalysis_tpu.plugins.builtin.cache_analysis import CacheAnalysisPlugin as JP
    from waveformanalysis_tpu.utils import cache_tools as jtools
    from waveformanalysis_tpu_torch.plugins.builtin.cache_analysis import CacheAnalysisPlugin
    from waveformanalysis_tpu_torch.utils import cache_tools

    _, j, t = stores
    assert cache_tools.cache_info(t, RUN)["n_entries"] == jtools.cache_info(j, RUN)["n_entries"]
    assert cache_tools.cache_health(t, RUN)["is_healthy"]
    assert cache_tools.cache_report(t, RUN).splitlines()[0] == \
        jtools.cache_report(j, RUN).splitlines()[0]
    assert cache_tools.clear_old_entries(t, 0.0, RUN, dry_run=True) == \
        jtools.clear_old_entries(j, 0.0, RUN, dry_run=True) > 0
    assert cache_tools.enforce_size_budget(t, 1e6, RUN, dry_run=True) == 0
    j.register(JP())
    t.register(CacheAnalysisPlugin())
    jr, tr = j.get_data(RUN, "cache_analysis"), t.get_data(RUN, "cache_analysis")
    assert tr["summary"]["n_entries"] == jr["summary"]["n_entries"]
    assert len(tr["entries"]) == len(jr["entries"]) and tr["diagnostics"]["is_healthy"]


def test_cache_manager_equals_jax(tmp_path):
    from waveformanalysis_tpu.storage.function_cache import CacheManager as JaxManager

    watched = tmp_path / "input.txt"
    watched.write_text("a")
    calls = []
    managers = (wa.CacheManager(tmp_path / "port"), JaxManager(tmp_path / "jax"))
    args = (3, np.arange(4))
    assert managers[0]._key("f", args, {"k": 1}, [watched]) == \
        managers[1]._key("f", args, {"k": 1}, [watched])

    @managers[0].cached(watch_files=lambda n, arr: [watched])
    def square(n, arr):
        calls.append(n)
        return arr ** n

    np.testing.assert_array_equal(square(*args), np.arange(4) ** 3)
    np.testing.assert_array_equal(square(*args), np.arange(4) ** 3)
    assert calls == [3] and square.cache_manager is managers[0]
    watched.write_text("changed, longer")
    square(*args)
    assert calls == [3, 3]
    assert managers[0].clear() == 2 and managers[0].clear() == 0


class _Fixed:
    """A stand-in Context whose get_data returns one fixed value."""

    def __init__(self, value):
        self.value = value

    def get_data(self, run_id, name):
        return self.value


EXPORT_COLUMNS = {
    "time": np.arange(6, dtype=np.int64),
    "channel": np.array([0, 1, 0, 1, 0, 1], dtype=np.int16),
    "area": np.linspace(-1.5, 2.5, 6).astype(np.float32),
    "wave": np.arange(24, dtype=np.float32).reshape(6, 4) / 3,
}


def read_back(path, fmt):
    if fmt == "csv":
        return pd.read_csv(path)
    if fmt == "json":
        return pd.read_json(path)
    if fmt == "parquet":
        return pd.read_parquet(path)
    if fmt == "npz":
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    return np.load(path)


@pytest.mark.parametrize("fmt", ["csv", "json", "parquet", "npy", "npz"])
def test_exporter_equals_jax_on_one_table(tmp_path, fmt):
    """The port's Table with tensor columns and the JAX Table with the same
    arrays export equal files (the port's columns go through to_host)."""
    port_table = wa.Table({k: torch.from_numpy(v.copy()) for k, v in EXPORT_COLUMNS.items()})
    jax_table = jwa.Table(dict(EXPORT_COLUMNS))
    paths = [wa.DataExporter(_Fixed(port_table)).export("r", "t", tmp_path / f"port.{fmt}"),
             jwa.DataExporter(_Fixed(jax_table)).export("r", "t", tmp_path / f"jax.{fmt}")]
    got, want = (read_back(p, fmt) for p in paths)
    if fmt in ("csv", "json"):
        assert paths[0].read_text() == paths[1].read_text()
    elif fmt == "parquet":
        assert list(got.columns) == list(want.columns)
        for col in want.columns:
            np.testing.assert_allclose(np.stack(got[col]).astype(np.float64),
                                       np.stack(want[col]), atol=ATOL, rtol=RTOL)
    elif fmt == "npz":
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="Unsupported"):
        wa.DataExporter(_Fixed(port_table)).export("r", "t", tmp_path / "x.xls")


def test_batch_export_of_a_run(stores, tmp_path):
    _, j, t = stores
    out = wa.DataExporter(t).batch_export(RUN, ["df_events", "basic_features"], tmp_path / "p",
                                          fmt="csv")
    ref = jwa.DataExporter(j).batch_export(RUN, ["df_events", "basic_features"],
                                           tmp_path / "j", fmt="csv")
    for name in out:
        a, b = pd.read_csv(ref[name]), pd.read_csv(out[name])
        assert list(a.columns) == list(b.columns) and len(a) == len(b) > 0


@pytest.mark.parametrize("target", ["df_paired", "hit_grouped", "s1_s2"])
def test_dependency_analysis_equals_jax(stores, target):
    _, j, t = stores
    want = j.analyze_dependencies(target, include_performance=False, run_id=RUN).to_dict()
    got = t.analyze_dependencies(target, include_performance=False, run_id=RUN).to_dict()
    assert got == want and len(got["plan"]) > 2
    timed = t.analyze_dependencies(target, run_id=RUN)
    assert set(timed.durations) == set(got["plan"])
    assert timed.critical_path[-1] == target and "critical path" in timed.summary()


@pytest.mark.parametrize("target", ["df_paired", "hit_grouped", "s1_s2"])
def test_lineage_graph_equals_jax(stores, target):
    from waveformanalysis_tpu.foundation.model import build_lineage_graph as jax_build

    _, j, t = stores
    want = jax_build(j.get_lineage(target), target, j.plugins)
    got = wa.build_lineage_graph(t.get_lineage(target), target, t.plugins)

    def nodes(m):
        return {k: (n.title, n.plugin_class, n.depth,
                    [(p.id, p.name, p.dtype) for p in n.in_ports],
                    [(p.id, p.name, p.dtype) for p in n.out_ports]) for k, n in m.nodes.items()}

    assert nodes(got) == nodes(want)
    assert [e.__dict__ for e in got.edges] == [e.__dict__ for e in want.edges]
    assert got.to_mermaid() == want.to_mermaid()
    assert (got.roots(), got.max_depth()) == (want.roots(), want.max_depth())
    assert isinstance(got, wa.LineageGraphModel)


def docs_cli(main, *args):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(list(args))
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("variant", ["human", "agent"])
def test_docs_pages_equal_jax(tmp_path, variant):
    from waveformanalysis_tpu.utils.cli_docs import main as jax_main
    from waveformanalysis_tpu_torch.utils.cli_docs import main as port_main

    dirs = tmp_path / "jax", tmp_path / "port"
    outs = [docs_cli(jax_main, "--out-dir", str(dirs[0]), "--profile", "cpu", "--variant",
                     variant, "generate"),
            docs_cli(port_main, "--out-dir", str(dirs[1]), "--profile", "cpu", "--variant",
                     variant, "--device", "cpu", "generate")]
    assert [o[0] for o in outs] == [0, 0]
    pages = sorted(p.name for p in dirs[0].iterdir())
    assert sorted(p.name for p in dirs[1].iterdir()) == pages and len(pages) > 20
    # the port carries JAX's option help word for word (it feeds spec_hash
    # and so every lineage key), so every page is JAX's whole
    for name in pages:
        a, b = ((d / name).read_text() for d in dirs)
        assert a == b, name
    for command in (["check"], ["coverage"], ["show", "df_events"], ["show", "nope"]):
        want = docs_cli(jax_main, "--out-dir", str(dirs[0]), "--profile", "cpu", "--variant",
                        variant, *command)
        got = docs_cli(port_main, "--out-dir", str(dirs[1]), "--profile", "cpu", "--variant",
                       variant, "--device", "cpu", *command)
        assert got == want, command


def test_docs_default_device_needs_a_card(tmp_path, monkeypatch):
    from waveformanalysis_tpu_torch.utils.cli_docs import main as port_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port_main(["--out-dir", str(tmp_path / "d"), "generate"])
    assert not (tmp_path / "d").exists()


def test_daq_inspection_equals_jax(stores):
    from waveformanalysis_tpu.utils.daq import DAQAnalyzer as JaxAnalyzer, DAQRun as JaxRun

    root = stores[0]
    data_root = str(root / "DAQ")
    run, jrun = wa.DAQRun(data_root, RUN), JaxRun(data_root, RUN)
    assert run.to_dict() == jrun.to_dict() and run.channels == [0, 1]
    assert run.overview() == jrun.overview()
    assert run.compute_acquisition_times() == jrun.compute_acquisition_times()
    assert run.get_channel_file_details(1) == jrun.get_channel_file_details(1)
    an, jan = wa.DAQAnalyzer(data_root), JaxAnalyzer(data_root)
    assert an.list_runs() == jan.list_runs() == [RUN]
    for kw in ({"color": False}, {"color": True}, {"html": True}):
        assert an.display_overview(**kw) == jan.display_overview(**kw)
    assert an.summary() == jan.summary() and an.to_dict() == jan.to_dict()
