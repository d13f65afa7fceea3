"""The port's examples that wait on the user utilities, and the two
multi-device examples, on the CPU.

Each of the thirteen runs at its demo shape through ``main(device="cpu")``
(matplotlib's Agg backend for the lineage plot) and its returned numbers
are held to what the JAX package's twin under ``examples/`` prints on the
same inputs. Together they take about 3 s here. Without a card the
default device raises, as every entry point of the port does.

Tolerance: counts, keys and labels exactly; the float32 means the examples
print are compared at the precision they are printed with (0.1).
"""

import contextlib
import importlib
import io

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402


def _default_plugins():
    from waveformanalysis_tpu_torch.plugins.plugin_sets import cuda_default

    return sorted(p.provides for p in cuda_default())


def _check_s1_s2(r):
    assert r == {"peaks": 432, "n_s1": 200, "n_s2": 232, "accuracy": 1.0}


def _check_widths(r):
    assert list(r) == [4.0, 20.0]
    got = {s: (round(v["edge"], 1), round(v["integral"], 1)) for s, v in r.items()}
    assert got == {4.0: (34.5, 22.8), 20.0: (171.7, 104.0)}


def _check_signal(r):
    assert r["events"] == 1000
    assert (round(r["mean_height"], 1), round(r["mean_area"], 1)) == (204.8, 2399.6)
    assert r["key"] == "demo_run-basic_features-763890d9"
    assert (r["cache_stats"]["misses"], r["cache_stats"]["memory_hits"]) == (1, 2)


def _check_dual(r):
    assert (r["h_computed"], r["h_overridden"]) == (153.0, 253.0)
    assert r["keys"] == ("demo-basic_features-763890d9", "demo-basic_features-c303080c")


def _check_config(r):
    assert r["resolved"] == {"height": 50.0, "distance": 4, "prominence": 1.0}
    assert r["rotated"] and r["keys"][0] != r["keys"][1]


def _check_list_configs(r):
    assert r == {"plugins": ["basic_features", "hit"], "hit_options": 18,
                 "modified": {"height": 123.0, "prominence": 9.0}}


def _check_progress(r):
    assert r == {"items": 20, "last": 361, "loaded": 5, "total": 2666646666700000,
                 "accumulated": 1225, "squares_tail": [49, 64, 81],
                 "tracker": "ProgressTracker", "time": "01:06:40",
                 "throughput": "1234567 wf/s"}


def _check_preview_execution(r):
    stages = ["raw_files", "st_waveforms", "filtered_waveforms", "hit", "waveform_width",
              "basic_features", "s1_s2"]
    assert r["plan"] == stages
    assert r["misses"] == [s for s in stages if s != "st_waveforms"]
    assert r["warm"] == stages[1:]
    assert r["s1_s2"] == {"rows": 0, "n_s1": 0, "n_s2": 0}


def _check_docs(r):
    assert r["first_line"] == "# `hit` — HitFinderPlugin"
    assert r["written"] == 22 and r["report"]["is_complete"]
    assert r["report"]["ok"] == _default_plugins()


def _check_lineage(r):
    assert r["plugins"] == _default_plugins()
    assert r["keys"][0] != r["keys"][1] == r["keys"][2]
    assert r["plot"] == "Axes"


def _check_preview(r):
    assert (r["events"], r["wave_length"], r["windowed"]) == (8, 48, 20)
    np.testing.assert_array_equal(np.round(r["height"]),
                                  [203, 203, 203, 203, 203, 203, 203, 202])
    np.testing.assert_array_equal(np.round(r["area"]),
                                  [1011, 1003, 1002, 998, 999, 1005, 996, 999])


def _check_multichip(r):
    # = the JAX package's examples/multichip_demo.py on its 8 virtual devices
    assert r == {"n_s1": 256, "n_s2": 256, "total_area": 4775666.0}


def _check_advanced(r):
    # = the JAX package's examples/tutorial_advanced.py (its step 7 reads
    # hit_threshold alone; the port adds waveform_width_integral so that the
    # request runs the fused program on the mesh)
    assert r["runs"] == ["run_000", "run_001", "run_002"] and r["pulse_width_rows"] == 96
    assert r["df"] == {"run_000": (96, 1001.2), "run_001": (96, 995.2), "run_002": (96, 999.5)}
    assert r["batched_rows"] == 288
    assert r["mesh_rows"] == {"hit_threshold": 96, "waveform_width_integral": 96}


EXAMPLES = {
    "multichip_demo": _check_multichip,
    "tutorial_advanced": _check_advanced,
    "s1_s2_pipeline_demo": _check_s1_s2,
    "waveform_width_example": _check_widths,
    "signal_processing_example": _check_signal,
    "dual_baseline_example": _check_dual,
    "config_management_example": _check_config,
    "list_plugin_configs_example": _check_list_configs,
    "progress_tracking_demo": _check_progress,
    "preview_execution_demo": _check_preview_execution,
    "doc_generator_demo": _check_docs,
    "verify_lineage_demo": _check_lineage,
    "preview_quickstart": _check_preview,
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_on_cpu(name):
    module = importlib.import_module(f"waveformanalysis_tpu_torch.examples.{name}")
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        result = module.main(device="cpu")
    assert said.getvalue().startswith("device: cpu\n")
    EXAMPLES[name](result)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            module.main()
