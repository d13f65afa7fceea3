"""The PyTorch/CUDA port's import and build guards, and its card-only test.

This file imports no JAX, so on a GPU machine without JAX it runs on its
own: ``python -m pytest --noconftest -q tests/test_torch_port_imports.py``.
Tolerance of the card test: integer, index, count and label outputs exact;
float32 outputs atol 1e-3 / rtol 1e-4.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
# modules the guard must find (it imports every module of the package)
KEY_MODULES = (
    "waveformanalysis_tpu_torch.ops.chain_scan_cuda",
    "waveformanalysis_tpu_torch.ops.chain_tile_cuda",
    "waveformanalysis_tpu_torch.examples.fused_chain_demo",
    "waveformanalysis_tpu_torch.ops.width_scan_cuda",
    "waveformanalysis_tpu_torch.ops.filtering",
    "waveformanalysis_tpu_torch.ops.filter_cuda",
    "waveformanalysis_tpu_torch.plugins.builtin.filtering",
    "waveformanalysis_tpu_torch.context.fusion",
    "waveformanalysis_tpu_torch.context.context",
    "waveformanalysis_tpu_torch.plugins.builtin.waveform_width",
    "waveformanalysis_tpu_torch.storage.memmap",
    "waveformanalysis_tpu_torch.kernels._build",
    "waveformanalysis_tpu_torch.formats.adapter",
    "waveformanalysis_tpu_torch.formats.vx2730",
    "waveformanalysis_tpu_torch.formats.v1725",
    "waveformanalysis_tpu_torch.formats.generic",
    "waveformanalysis_tpu_torch.native",
    "waveformanalysis_tpu_torch.processing.loader",
    "waveformanalysis_tpu_torch.processing.analyzer",
    "waveformanalysis_tpu_torch.processing.records_builder",
    "waveformanalysis_tpu_torch.plugins.builtin.waveforms",
    "waveformanalysis_tpu_torch.plugins.builtin.dataframe",
    "waveformanalysis_tpu_torch.plugins.builtin.event_analysis",
    "waveformanalysis_tpu_torch.plugins.plugin_sets",
    "waveformanalysis_tpu_torch.ops.grouping",
    "waveformanalysis_tpu_torch.ops.grouping_device",
    "waveformanalysis_tpu_torch.examples.tutorial",
    "waveformanalysis_tpu_torch.data.records_view",
    "waveformanalysis_tpu_torch.data.query",
    "waveformanalysis_tpu_torch.plugins.builtin.records",
    "waveformanalysis_tpu_torch.ops.v1725_device",
    "waveformanalysis_tpu_torch.examples.records_pipeline_example",
    "waveformanalysis_tpu_torch.examples.records_view_example",
    "waveformanalysis_tpu_torch.execution.manager",
    "waveformanalysis_tpu_torch.execution.cancellation",
    "waveformanalysis_tpu_torch.execution.timeout",
    "waveformanalysis_tpu_torch.execution.load_balancer",
    "waveformanalysis_tpu_torch.data.batch_processor",
    "waveformanalysis_tpu_torch.examples.batched_multirun_demo",
    "waveformanalysis_tpu_torch.dtypes.chunk",
    "waveformanalysis_tpu_torch.plugins.streaming",
    "waveformanalysis_tpu_torch.plugins.device_stream",
    "waveformanalysis_tpu_torch.plugins.builtin.signal_peaks",
    "waveformanalysis_tpu_torch.examples.streaming_demo",
    "waveformanalysis_tpu_torch.storage.cache_ops",
    "waveformanalysis_tpu_torch.utils.cache_tools",
    "waveformanalysis_tpu_torch.plugins.builtin.cache_analysis",
    "waveformanalysis_tpu_torch.storage.function_cache",
    "waveformanalysis_tpu_torch.data.dependency_analysis",
    "waveformanalysis_tpu_torch.data.export",
    "waveformanalysis_tpu_torch.foundation.model",
    "waveformanalysis_tpu_torch.utils.daq",
    "waveformanalysis_tpu_torch.cli",
    "waveformanalysis_tpu_torch.cli_cache",
    "waveformanalysis_tpu_torch.utils.plugin_doc_generator",
    "waveformanalysis_tpu_torch.utils.doc_coverage",
    "waveformanalysis_tpu_torch.utils.cli_docs",
    "waveformanalysis_tpu_torch.server",
    "waveformanalysis_tpu_torch.plugins.adapters",
    "waveformanalysis_tpu_torch.plugins.loader",
    "waveformanalysis_tpu_torch.plugins.hot_reload",
    "waveformanalysis_tpu_torch.utils.io",
    "waveformanalysis_tpu_torch.utils.preview",
    "waveformanalysis_tpu_torch.utils.visualization",
    "waveformanalysis_tpu_torch.utils.event_filters",
    "waveformanalysis_tpu_torch.examples.s1_s2_pipeline_demo",
    "waveformanalysis_tpu_torch.examples.waveform_width_example",
    "waveformanalysis_tpu_torch.examples.signal_processing_example",
    "waveformanalysis_tpu_torch.examples.dual_baseline_example",
    "waveformanalysis_tpu_torch.examples.config_management_example",
    "waveformanalysis_tpu_torch.examples.list_plugin_configs_example",
    "waveformanalysis_tpu_torch.examples.progress_tracking_demo",
    "waveformanalysis_tpu_torch.examples.preview_execution_demo",
    "waveformanalysis_tpu_torch.examples.doc_generator_demo",
    "waveformanalysis_tpu_torch.examples.verify_lineage_demo",
    "waveformanalysis_tpu_torch.examples.preview_quickstart",
    "waveformanalysis_tpu_torch.parallel",
    "waveformanalysis_tpu_torch.parallel.mesh",
    "waveformanalysis_tpu_torch.parallel.scan",
    "waveformanalysis_tpu_torch.parallel.sorted_merge",
    "waveformanalysis_tpu_torch.examples.multichip_demo",
    "waveformanalysis_tpu_torch.examples.tutorial_advanced",
)


def test_port_imports_without_jax():
    """A fresh import of every module of the port (the demo among them),
    with every facade name resolved, loads neither jax nor any module of
    the JAX package (waveformanalysis_tpu)."""
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import waveformanalysis_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "names = [n for n in pkg.__all__ if getattr(pkg, n) is not None]\n"
        "print(json.dumps({'modules': mods, 'names': names, 'leaked': sorted(m for m in\n"
        "    sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'waveformanalysis_tpu'))}))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(KEY_MODULES) <= set(result["modules"])
    assert {"ChainConfig", "make_chain_tile", "chain_tile_cuda", "Context", "get_profile",
            "cuda_default", "get_adapter", "group_multi_channel_hits", "RecordsView",
            "TimeRangeQueryEngine", "BatchProcessor", "ExecutorManager",
            "parallel_map", "PipelineServer", "DataExporter", "DependencyAnalyzer",
            "CacheManager", "DAQRun", "DAQAnalyzer", "LineageGraphModel",
            "build_lineage_graph", "wrap_strax_plugin", "StraxContextAdapter",
            "PluginLoader", "enable_hot_reload", "PluginHotReloader", "parse_and_stack_files",
            "WaveformPreviewer", "preview_waveforms", "plot_records_waveforms",
            "plot_lineage_labview", "plot_lineage_plotly", "plot_waveforms",
            "create_interactive_browser", "LineageStyle", "make_sharded_chain",
            "make_sharded_chain_scan", "make_sharded_chain_tile"} <= set(result["names"])
    assert result["leaked"] == []


TOOLS = ("assess_change_impact", "benchmark_io", "check_doc_sync", "fuzz_chain_configs",
         "performance_regression_check", "scaffold_plugin", "schema_compat_check",
         "verify_install")


def test_port_tools_import_without_jax():
    """Every scripts/*_torch.py imports with jax, jaxlib and the JAX package
    blocked, and the fuzz's card path (K1 and K7 against the plain chain,
    here on CPU tensors), the schema check and the install check run so:
    only the fuzz's CPU reference needs JAX."""
    assert sorted(p.name[:-len("_torch.py")] for p in (ROOT / "scripts").glob("*_torch.py")) \
        == sorted(TOOLS)
    code = (
        "import contextlib, importlib, io, json, sys\n"
        "for name in ('jax', 'jaxlib', 'waveformanalysis_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"sys.path.insert(0, {str(ROOT / 'scripts')!r})\n"
        f"tools = {{n: importlib.import_module(n + '_torch') for n in {TOOLS!r}}}\n"
        "fuzz = tools['fuzz_chain_configs']\n"
        "status = [fuzz.card_trial(a, f, 'cpu')['status']\n"
        "          for _, _, a, f in fuzz.trials(2, 99, rows=slice(0, 16))]\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    rcs = [tools['schema_compat_check'].main([]),\n"
        "           tools['verify_install'].main(['--device', 'cpu'])]\n"
        "print(json.dumps({'status': status, 'rcs': rcs, 'leaked': sorted(m for m in\n"
        "    sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'waveformanalysis_tpu')\n"
        "    and sys.modules[m] is not None)}))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result == {"status": ["OK", "OK"], "rcs": [0, 0], "leaked": []}


def test_loader_names_nvcc_when_missing(monkeypatch, tmp_path):
    from waveformanalysis_tpu_torch.kernels import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.find_nvcc()
    _build.build.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build("chain_scan")
    _build.build.cache_clear()


def test_cpu_call_never_touches_loader(monkeypatch):
    from waveformanalysis_tpu_torch.kernels import _build
    from waveformanalysis_tpu_torch.models.full_chain import example_chain_batch
    from waveformanalysis_tpu_torch.ops import chain_scan_cuda as csc

    def refuse(name):
        raise AssertionError("the loader was called for CPU tensors")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(csc, "_library", lambda: refuse("chain_scan"))
    before = csc.chain_scan_cuda.launches
    out = csc.make_chain_scan()(*example_chain_batch(8, 128, device="cpu"))
    assert csc.chain_scan_cuda.launches == before
    assert out["label"].dtype == torch.int8 and out["label"].shape == (8,)


def test_cpu_filter_calls_never_touch_loader(monkeypatch):
    """The filter wrappers, the tensor entries and the array entries on the
    CPU run the plain versions: no build, no launch."""
    from waveformanalysis_tpu_torch.kernels import _build
    from waveformanalysis_tpu_torch.ops import filter_cuda as flc
    from waveformanalysis_tpu_torch.ops import filtering as flt

    def refuse(*args):
        raise AssertionError("the loader was called for CPU tensors")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(flc, "_library", refuse)
    before = (flc.sosfiltfilt_cuda.launches, flc.sosfilt_cuda.launches)
    sos = flt.design_butterworth_sos(4, 0.002, 0.1, 0.5)
    x = torch.as_tensor(np.random.default_rng(0).normal(1000, 30, (6, 96)), dtype=torch.float32)
    outs = [flc.sosfiltfilt_cuda(x, sos), flc.sosfiltfilt_cuda(x, sos, fused=False),
            flt.sosfiltfilt(x, sos), flt.apply_filter(x, "BW", bw_sos=sos)]
    for out in outs[1:]:
        assert torch.equal(out, outs[0])
    np.testing.assert_array_equal(flt.sosfiltfilt_device(x.numpy(), sos, device="cpu"),
                                  outs[0].numpy())
    zi = torch.zeros((2 * sos.shape[0], 6))
    for reverse in (False, True):
        assert flc.sosfilt_cuda(x, sos, zi, reverse=reverse).shape == (6, 96)
    assert flt.savgol(x, 11, 2).shape == x.shape
    assert (flc.sosfiltfilt_cuda.launches, flc.sosfilt_cuda.launches) == before


def test_cuda_wrapper_rejects_bad_inputs_before_building(monkeypatch):
    """Dtype/shape checks raise before any build; mixed devices raise."""
    from waveformanalysis_tpu_torch.models.full_chain import ChainConfig
    from waveformanalysis_tpu_torch.ops import chain_scan_cuda as csc

    w = torch.zeros((4, 64), dtype=torch.int16)
    el = torch.full((4,), 64, dtype=torch.int32)
    bl = torch.zeros(4)
    pol = torch.ones(4, dtype=torch.int8)
    monkeypatch.setattr(csc, "_library", lambda: pytest.fail("built too early"))
    with pytest.raises(TypeError, match="int16"):
        csc._launch(w.to(torch.int32), el, bl, pol, ChainConfig())
    with pytest.raises(ValueError, match="shape"):
        csc._launch(w, el[:3], bl, pol, ChainConfig())
    with pytest.raises(ValueError, match="slots"):
        csc._launch(w, el, bl, pol, ChainConfig(max_peaks=33))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        csc.chain_scan_cuda(w.to("meta"), el, bl, pol)


def test_parse_ptxas():
    from waveformanalysis_tpu_torch.kernels._build import parse_ptxas

    log = (
        "ptxas info    : Compiling entry function '_Z1kILi8EEv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1kILi8EEv\n"
        "    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 96 registers, used 0 barriers, 600 bytes cmem[0]\n"
    )
    assert parse_ptxas(log) == [{"function": "_Z1kILi8EEv", "spill_stores": 4,
                                 "spill_loads": 12, "registers": 96}]


def test_resolve_device_refuses_missing_cuda(monkeypatch):
    from waveformanalysis_tpu_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")


def test_default_device_is_cuda(monkeypatch):
    """The port runs on the card unless asked for the CPU: the default and
    None resolve to CUDA, so without a card they raise."""
    from waveformanalysis_tpu_torch.device import resolve_device
    from waveformanalysis_tpu_torch.models.full_chain import example_chain_batch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from waveformanalysis_tpu_torch.context.context import Context
    from waveformanalysis_tpu_torch.ops import filtering as flt

    waves = np.full((4, 64), 1000.0, np.float32)
    sos = flt.design_butterworth_sos(2, 0.1, 0.2, 0.5)
    view = type("View", (), {"records": {"wave_offset": np.array([0]),
                                         "event_length": np.array([64])},
                             "wave_pool": np.zeros(64, np.int16)})()
    for call in (resolve_device, lambda: resolve_device(None),
                 lambda: example_chain_batch(4, 128), Context,
                 lambda: flt.sosfiltfilt_device(waves, sos),
                 lambda: flt.sosfiltfilt_device(waves[:, :8], sos),  # even a pass-through
                 lambda: flt.savgol_device(waves, 11, 2),
                 lambda: flt.apply_filter(waves, "SG", sg_window_size=11, sg_poly_order=2),
                 lambda: flt.filter_pool(view, "savgol")):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against the plain version on CUDA tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    from waveformanalysis_tpu_torch.models.full_chain import (
        ChainConfig,
        batch_from_numpy,
        full_chain_step,
    )
    from waveformanalysis_tpu_torch.ops.chain_scan_cuda import chain_scan_cuda

    rng = np.random.default_rng(4)
    n, L = 1000, 192  # a ragged tail: n is not a multiple of the block
    waves = np.round(1000 + rng.normal(0, 30, (n, L))).astype(np.int16)
    waves[:, 80:90] += 200
    el = rng.integers(L // 2, L + 1, n).astype(np.int32)
    bl = np.full(n, 1000.0, np.float32)
    pol = rng.choice(np.array([-1, 0, 1], np.int8), n)
    for cfg in (ChainConfig(use_derivative=False, peak_height=40.0,
                            peak_prominence=10.0, peak_width=1.0),
                ChainConfig(), ChainConfig(max_peaks=16, max_hits=32)):
        batch = batch_from_numpy(waves, el, bl, pol, device="cuda")
        before = chain_scan_cuda.launches
        out = chain_scan_cuda(*batch, cfg)
        torch.cuda.synchronize()
        assert chain_scan_cuda.launches == before + 1
        ref = full_chain_step(*batch, cfg)
        assert list(out) == list(ref)
        for k in ref:
            a, b = ref[k].cpu().numpy(), out[k].cpu().numpy()
            assert a.dtype == b.dtype, k
            if np.issubdtype(a.dtype, np.integer):
                np.testing.assert_array_equal(b, a, err_msg=k)
            else:
                np.testing.assert_allclose(b, a, atol=1e-3, rtol=1e-4, err_msg=k)


@pytest.mark.cuda
def test_scan_kernels_match_plain_on_card():
    """The peaks, hits and width scan kernels against their plain versions
    on CUDA tensors: counts, positions and validity exact, slot values where
    the slot is valid (width crossings on every slot)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    from waveformanalysis_tpu_torch.ops import chain_scan_cuda as csc
    from waveformanalysis_tpu_torch.ops import width_scan_cuda as wsc
    from waveformanalysis_tpu_torch.ops.hits import threshold_hits_batch
    from waveformanalysis_tpu_torch.ops.peaks import find_peaks_batch

    rng = np.random.default_rng(5)
    n, L = 1000, 160  # a ragged tail: n is not a multiple of the block
    waves = np.round(1000 + rng.normal(0, 20, (n, L))).astype(np.int16)
    waves[:, 60:75] += 150
    w = torch.as_tensor(waves, device="cuda")
    sig = w.float() - 1000.0
    vl = torch.as_tensor(rng.integers(L // 2, L + 1, n).astype(np.int32), device="cuda")
    thr = torch.as_tensor(rng.uniform(20, 60, n).astype(np.float32), device="cuda")

    def same(ref, out, valid=None, slot_keys=()):
        assert list(out) == list(ref)
        for k in ref:
            a, b = ref[k].cpu().numpy(), out[k].cpu().numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, k
            if k in slot_keys:
                a, b = a[valid], b[valid]
            if np.issubdtype(a.dtype, np.floating):
                np.testing.assert_allclose(b, a, atol=1e-3, rtol=1e-4, err_msg=k)
            else:
                np.testing.assert_array_equal(b, a, err_msg=k)

    kw = dict(height=40.0, prominence=10.0, width=1.0, distance=3, max_peaks=16)
    peaks = csc.find_peaks_scan(sig, valid_length=vl, **kw)
    ref = find_peaks_batch(sig, valid_length=vl, **kw)
    same(ref, peaks, ref["valid"].cpu().numpy(),
         ("peak_value", "prominence", "left_ips", "right_ips", "widths",
          "left_bases", "right_bases"))
    hits = csc.threshold_hits_scan(sig, thr, vl, max_hits=8)
    ref = threshold_hits_batch(sig, thr, vl, max_hits=8)
    same(ref, hits, ref["valid"].cpu().numpy(),
         ("position", "height", "integral", "seg_start", "seg_end", "run_start", "run_end"))
    bl = w.float()[:, :50].sum(dim=1) / 50
    args = (w, bl, peaks["position"], 0.1, 0.9, 0.9, 0.1)
    same(wsc.width_crossings_plain(*args), wsc.width_crossings_scan(*args))


@pytest.mark.cuda
def test_filter_kernels_match_plain_on_card():
    """K5 (one launch) and K6 (two launches in the two-pass mode) against
    the plain version on CUDA tensors, for 1 to 9 sections (more than four
    run the cascade in chunks); expected bit-equal, held to 1e-6 of the
    largest |value|. A short wave passes through without a launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    from waveformanalysis_tpu_torch.ops import filter_cuda as flc
    from waveformanalysis_tpu_torch.ops import filtering as flt

    rng = np.random.default_rng(6)
    n, L = 1000, 200  # a ragged tail: n is not a multiple of the block
    t = np.arange(L)
    waves = np.round(1000 + rng.normal(0, 20, (n, L))
                     + 300 * np.exp(-((t - 90) ** 2) / 40.0)).astype(np.float32)
    x = torch.as_tensor(waves, device="cuda")
    for order, lo, hi in ((1, 0.01, 0.2), (2, 0.1, 0.2), (3, 0.01, 0.15), (4, 0.002, 0.1),
                          (5, 0.01, 0.2), (9, 0.02, 0.2)):
        sos = flt.design_butterworth_sos(order, lo, hi, 0.5)
        ref = flt.sosfiltfilt_plain(x, sos)
        b5, b6 = flc.sosfiltfilt_cuda.launches, flc.sosfilt_cuda.launches
        fused = flc.sosfiltfilt_cuda(x, sos)
        two = flc.sosfiltfilt_cuda(x, sos, fused=False)
        torch.cuda.synchronize()
        assert (flc.sosfiltfilt_cuda.launches, flc.sosfilt_cuda.launches) == (b5 + 1, b6 + 2)
        scale = float(ref.abs().max())
        for out in (fused, two):
            assert out.dtype == torch.float32 and out.shape == (n, L)
            assert float((out - ref).abs().max()) <= 1e-6 * scale, order
    short = x[:, :20]
    b5 = flc.sosfiltfilt_cuda.launches
    assert torch.equal(flt.sosfiltfilt(short, flt.design_butterworth_sos(4, 0.002, 0.1, 0.5)),
                       short)
    assert flc.sosfiltfilt_cuda.launches == b5


@pytest.mark.cuda
@pytest.mark.parametrize("order", [1, 2, 3, 4, 6, 9])
def test_one_direction_kernel_matches_plain_on_card(order):
    """K6 against sosfilt_plain on CUDA tensors, forward and in reverse,
    bit for bit: 1,001 events (the last warp holds 9), rows of 45 samples
    (no multiple of the 32-sample chunk), 310 (route B's reflected rows) and
    4,096, a random initial state; one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    from waveformanalysis_tpu_torch.ops import filter_cuda as flc
    from waveformanalysis_tpu_torch.ops import filtering as flt

    rng = np.random.default_rng(order)
    sos = flt.design_butterworth_sos(order, 0.01, 0.2, 0.5)
    n = 1_001
    zi = torch.as_tensor(rng.normal(0, 20, (2 * sos.shape[0], n)), dtype=torch.float32,
                         device="cuda")
    for T in (45, 310, 4_096):
        x = torch.as_tensor(rng.normal(0, 50, (n, T)), dtype=torch.float32, device="cuda")
        for reverse in (False, True):
            before = flc.sosfilt_cuda.launches
            out = flc.sosfilt_cuda(x, sos, zi, reverse=reverse)
            torch.cuda.synchronize()
            assert flc.sosfilt_cuda.launches == before + 1
            ref = flt.sosfilt_plain(x, sos, zi, reverse=reverse)
            assert out.shape == (n, T) and torch.equal(out, ref), (T, reverse)
