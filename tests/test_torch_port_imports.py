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
    "waveformanalysis_tpu_torch.ops.width_scan_cuda",
    "waveformanalysis_tpu_torch.context.fusion",
    "waveformanalysis_tpu_torch.context.context",
    "waveformanalysis_tpu_torch.plugins.builtin.waveform_width",
    "waveformanalysis_tpu_torch.storage.memmap",
    "waveformanalysis_tpu_torch.kernels._build",
)


def test_port_imports_without_jax():
    """A fresh import of every module of the port loads neither jax nor
    any module of the JAX package (waveformanalysis_tpu)."""
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import waveformanalysis_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps({'modules': mods, 'leaked': sorted(m for m in sys.modules\n"
        "    if m.split('.')[0] in ('jax', 'jaxlib', 'waveformanalysis_tpu'))}))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(KEY_MODULES) <= set(result["modules"])
    assert result["leaked"] == []


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

    for call in (resolve_device, lambda: resolve_device(None),
                 lambda: example_chain_batch(4, 128), Context):
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
