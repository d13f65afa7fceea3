"""The port's tools (scripts/*_torch.py), called in-process on the CPU.

The twin of each test in tests/test_quality_scripts.py, plus: the random-
config chain fuzz against the JAX package (seed 99, 2 trials, all OK), the
split inside the JAX package's reference pinned on rows 240-247 of seed 7,
trial 20 (the port and the JAX Pallas chain kernel agree, the XLA chain
differs on row 243 alone), the install check with its kernel step not run,
the IO benchmark, and the committed docs/schema_snapshot.json left byte for
byte as it was.
"""

import contextlib
import importlib
import io
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
SNAPSHOT = REPO / "docs" / "schema_snapshot.json"
sys.path.insert(0, str(REPO / "scripts"))


def tool(name):
    return importlib.import_module(f"{name}_torch")


def run(name, *args):
    """(exit code, stdout, stderr) of a tool's ``main``."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = tool(name).main(list(args))
    return rc, out.getvalue(), err.getvalue()


class TestScaffoldPlugin:
    def test_generates_loadable_plugin_and_test(self, tmp_path):
        rc, out, err = run("scaffold_plugin", "my_feature", "--out-dir", str(tmp_path),
                           "--test-dir", str(tmp_path))
        assert rc == 0, err
        files = sorted(p.name for p in tmp_path.glob("*.py"))
        assert files == ["my_feature.py", "test_torch_my_feature.py"]
        src = (tmp_path / "my_feature.py").read_text()
        assert "my_feature" in src and "Plugin" in src and "def device_stage" in src
        assert "jax" not in src

        from waveformanalysis_tpu_torch.context.context import Context
        from waveformanalysis_tpu_torch.plugins.loader import PluginLoader

        classes = PluginLoader().discover_directory(str(tmp_path))
        assert any(c.provides == "my_feature" for c in classes)
        ctx = Context(storage_dir=str(tmp_path / "cache"),
                      config={"show_progress": False, "device": "cpu"})
        ctx.register(next(c for c in classes if c.provides == "my_feature")())
        assert ctx.get_plugin("my_feature") is not None

        # the generated parity test passes: the device stage = its plain twin
        sys.path.insert(0, str(tmp_path))
        try:
            gen = importlib.import_module("test_torch_my_feature")
            gen.test_my_feature_device_stage_equals_plain("cpu")
            gen.test_my_feature_runs(tmp_path / "ctx", "cpu")
        finally:
            sys.path.remove(str(tmp_path))
            for name in ("test_torch_my_feature", "my_feature"):
                sys.modules.pop(name, None)

    def test_refuses_existing_plugin(self, tmp_path):
        (tmp_path / "hit2.py").write_text("")
        rc, _, err = run("scaffold_plugin", "hit2", "--out-dir", str(tmp_path),
                         "--test-dir", str(tmp_path))
        assert rc == 1 and "already exists" in err


class TestSchemaCompatCheck:
    def test_snapshot_matches_checked_in_baseline(self):
        """The port's cuda profile is compatible with the JAX package's
        committed snapshot, and equal to it: the same bytes come out."""
        rc, out, _ = run("schema_compat_check")
        assert rc == 0, out
        assert "schemas compatible (21 plugins)" in out

    def test_detects_breaking_drift(self, tmp_path):
        mutated = json.loads(SNAPSHOT.read_text())
        name = "basic_features"
        mutated[name]["fields"]["ghost_field"] = "<f4"
        alt = tmp_path / "snap.json"
        alt.write_text(json.dumps(mutated))
        rc, out, _ = run("schema_compat_check", "--snapshot", str(alt))
        assert rc != 0
        assert name in out

    def test_snapshot_file_unchanged(self, tmp_path):
        before = SNAPSHOT.read_bytes()
        rc, _, err = run("schema_compat_check", "--update")
        assert rc == 2 and "refusing" in err
        rc, _, err = run("schema_compat_check", "--update", "--snapshot", str(SNAPSHOT))
        assert rc == 2 and "refusing" in err
        fresh = tmp_path / "snap.json"
        assert run("schema_compat_check", "--update", "--snapshot", str(fresh))[0] == 0
        assert fresh.read_bytes() == before
        assert SNAPSHOT.read_bytes() == before


class TestChangeImpact:
    def test_maps_kernel_file_to_consumers(self):
        rc, out, err = run("assess_change_impact", "--file",
                           "waveformanalysis_tpu_torch/ops/widths.py")
        assert rc == 0, err
        assert "waveform_width" in out

    @pytest.mark.parametrize("source,changed", [
        ("csrc/width_scan.cu", ["waveform_width", "waveform_width_integral"]),
        ("csrc/peaks_scan.cu", ["hit", "hit_threshold"]),
        ("csrc/sosfilt.cu", ["filtered_waveforms", "records", "wave_pool",
                             "wave_pool_filtered"]),
    ])
    def test_maps_cuda_source_through_its_wrapper(self, source, changed):
        rc, out, err = run("assess_change_impact", "--json", "--file",
                           f"waveformanalysis_tpu_torch/{source}")
        assert rc == 0, err
        report = json.loads(out)
        assert report["changed"] == changed
        assert set(changed) <= set(report["impacted"])

    def test_unknown_plugin_errors_cleanly(self):
        rc, _, err = run("assess_change_impact", "not_a_plugin")
        assert rc != 0
        assert "unknown plugin" in err

    def test_reports_stale_cache_entries(self, tmp_path):
        from waveformanalysis_tpu_torch.context.context import Context
        from waveformanalysis_tpu_torch.plugins.plugin_sets import get_profile

        tool("performance_regression_check").write_run(str(tmp_path), "r", 2, 8, 64)
        config = {"data_root": str(tmp_path), "daq_adapter": "vx2730"}
        with Context(storage_dir=str(tmp_path / "s"),
                     config={**config, "show_progress": False, "device": "cpu"}) as ctx:
            ctx.register(*get_profile("cuda"))
            ctx.get_data("r", "basic_features")
            key = ctx.key_for("r", "basic_features")
        rc, out, err = run("assess_change_impact", "basic_features",
                           "--storage-dir", str(tmp_path / "s"), "--run-id", "r",
                           "--config-json", json.dumps(config))
        assert rc == 0, err
        stale = [ln for ln in out.splitlines() if ln.startswith("stale cache:")]
        assert stale == [f"stale cache: basic_features ({key})"]


class TestPerfRegressionHarness:
    def test_measures_targets_on_synthetic_run(self, tmp_path):
        base = tmp_path / "base.json"
        rc, out, err = run("performance_regression_check", "--device", "cpu", "--targets",
                           "basic_features", "--reps", "1", "--save-baseline", str(base))
        assert rc == 0, err[-500:]
        assert "basic_features" in out and "device peak" not in out
        saved = json.loads(base.read_text())
        assert set(saved["basic_features"]) == {"avg_s", "max_s", "peak_mb"}
        saved["basic_features"]["avg_s"] = 1e-9
        base.write_text(json.dumps(saved))
        rc, out, _ = run("performance_regression_check", "--device", "cpu", "--targets",
                         "basic_features", "--reps", "1", "--baseline", str(base))
        assert rc == 1 and "REGRESSIONS" in out


class TestDocSyncCheck:
    def test_committed_docs_in_sync_both_variants(self):
        rc, out, err = run("check_doc_sync")
        assert rc == 0, out + err
        assert "doc-sync OK [human]" in out
        assert "doc-sync OK [agent]" in out

    def test_detects_drift_in_single_dir_mode(self, tmp_path):
        drifted = tmp_path / "plugins"
        shutil.copytree(REPO / "docs" / "plugins", drifted,
                        ignore=shutil.ignore_patterns("agent"))
        page = drifted / "hit.md"
        page.write_text(page.read_text() + "\nhand edit\n")
        rc, out, _ = run("check_doc_sync", "--docs-dir", str(drifted))
        assert rc == 1
        assert "hit.md: content drift" in out

    def test_detects_missing_page(self, tmp_path):
        drifted = tmp_path / "agent"
        shutil.copytree(REPO / "docs" / "plugins" / "agent", drifted)
        (drifted / "hit.md").unlink()
        rc, out, _ = run("check_doc_sync", "--docs-dir", str(drifted),
                         "--variant", "agent")
        assert rc == 1
        assert "hit.md: missing from committed docs" in out


class TestChainFuzz:
    def test_generator_equals_jax_tool(self, monkeypatch):
        """A seed draws the JAX tool's configs and waves: its loop body, run
        with the JAX chains replaced by a recorder, sees the same inputs."""
        import jax.numpy as jnp

        jtool = importlib.import_module("fuzz_chain_configs")
        seen = []

        def record(*args, **kw):
            seen.append((tuple(np.asarray(a) for a in args[:4]), args[4]))
            return {"x": jnp.zeros(1)}

        monkeypatch.setattr(jtool, "full_chain_step", record)
        monkeypatch.setattr(jtool, "chain_scan_pallas", record)
        with contextlib.redirect_stdout(io.StringIO()):
            jtool.main(2, seed=5)
        ours = list(tool("fuzz_chain_configs").trials(2, 5))
        assert len(ours) == 2 and len(seen) == 4
        for (_, L, arrays, fields), (jarrays, jcfg) in zip(ours, seen[::2]):
            assert arrays[0].shape[1] == L
            for a, b in zip(arrays, jarrays):
                np.testing.assert_array_equal(a, b)
            assert fields == {k: getattr(jcfg, k) for k in fields}

    def test_seed_99_all_ok(self):
        results = []
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = tool("fuzz_chain_configs").main(["--device", "cpu", "--trials", "2",
                                                  "--seed", "99"], results)
        assert rc == 0, out.getvalue()
        assert [r["status"] for r in results] == ["OK", "OK"]
        assert "ok 2, reference splits 0, port mismatches 0" in out.getvalue()

    def test_reference_split_pinned(self):
        """Seed 7, trial 20, rows 240-247 rebuilt from the generator: at row
        243 the width baseline is exactly the peak's value, a tie that JAX's
        XLA chain breaks through a fused multiply-add. The port equals the
        JAX Pallas chain kernel (interpret mode) on every output; the XLA
        chain differs from both on that row alone, in label and width."""
        fuzz = tool("fuzz_chain_configs")
        results = []
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = fuzz.main(["--device", "cpu", "--trials", "21", "--seed", "7", "--only",
                            "20", "--rows", "240:248"], results)
        assert rc == 0
        (res,) = results
        assert res["trial"] == 20 and res["status"] == fuzz.SPLIT
        port, xla, pallas = (res["outputs"][k] for k in ("port", "xla", "pallas"))
        assert list(port) == list(pallas) == list(xla)
        for k in port:
            if np.issubdtype(port[k].dtype, np.floating):
                np.testing.assert_allclose(port[k], pallas[k], atol=fuzz.ATOL,
                                           rtol=fuzz.RTOL, err_msg=k)
            else:
                np.testing.assert_array_equal(port[k], pallas[k], err_msg=k)
        assert sorted(res["bad"]) == ["label", "width_samples"]
        for k, mask in res["bad"].items():
            assert np.flatnonzero(mask).tolist() == [3], k
        assert (int(xla["label"][3]), float(xla["width_samples"][3])) == (1, 1.125)
        assert (int(port["label"][3]), float(port["width_samples"][3])) == (0, 0.0)
        text = out.getvalue()
        assert "trial 20 L=192 deriv=True K=4 Kh=8: reference split" in text
        assert "    row 243 label: port 0, xla 1, pallas 0" in text
        assert "reference splits 1, port mismatches 0" in text

    def test_port_mismatch_exits_1(self, monkeypatch):
        """A port that differs from both references is reported and fails."""
        fuzz = tool("fuzz_chain_configs")
        plain = fuzz.port_plain

        def broken(arrays, fields, device):
            out = plain(arrays, fields, device)
            out["n_hits"] = out["n_hits"] + 1
            return out

        monkeypatch.setattr(fuzz, "port_plain", broken)
        monkeypatch.setattr(fuzz, "jax_chains",
                            lambda arrays, fields, pallas=False: plain(arrays, fields, "cpu"))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = fuzz.main(["--device", "cpu", "--trials", "1", "--rows", "0:4"])
        assert rc == 1
        assert "PORT MISMATCH ['n_hits']" in out.getvalue()
        assert "row 0 n_hits:" in out.getvalue() and "'max_hits'" in out.getvalue()

    def test_card_path_on_cpu_tensors(self):
        """The card path's functions on CPU tensors (the wrappers' plain
        versions) hold K1 and K7 to the plain chain."""
        fuzz = tool("fuzz_chain_configs")
        for trial, L, arrays, fields in fuzz.trials(2, 99, rows=slice(0, 32)):
            res = fuzz.card_trial(arrays, fields, torch.device("cpu"))
            assert res["status"] == fuzz.OK and res["worst"] == 0.0
            assert set(res["outputs"]) == {"plain", "K1", "K7"}

    def test_default_device_needs_a_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="cuda"):
            tool("fuzz_chain_configs").main(["--trials", "1"])


class TestVerifyInstall:
    def test_cpu_passes_with_kernel_step_not_run(self):
        rc, out, _ = run("verify_install", "--device", "cpu")
        assert rc == 0, out
        assert "not run: device cpu: first-use kernel build" in out
        assert "install check: OK (4 of 5 steps passed, 1 not run, 0 failed)" in out
        assert "cache round-trip bit-identical" in out

    def test_default_device_needs_a_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="cuda"):
            tool("verify_install").main([])


class TestBenchmarkIO:
    def test_times_every_engine_and_job_count(self):
        rc, out, err = run("benchmark_io", "--n-files", "2", "--n-rows", "8",
                           "--n-samples", "32", "--reps", "1", "--engines",
                           "native,numpy", "--jobs", "1,2")
        assert rc == 0, err
        results = json.loads(out.strip().splitlines()[-1])["results"]
        assert [(r["engine"], r["n_jobs"]) for r in results] == [
            ("native", 1), ("native", 2), ("numpy", 1), ("numpy", 2)]
        assert all(r["rows_per_s"] > 0 for r in results)
