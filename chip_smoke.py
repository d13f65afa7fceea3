#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA chain kernel from the sources in this checkout,
holds it against its plain PyTorch version on the card, drives the port's
main path (``make_chain_scan`` on bench.py's workload, 65536 x 256) and
checks its S1/S2 and overflow counts against the values the JAX package's
XLA chain gives on the same batch (pinned by tests/test_torch_chain_scan.py),
then times the kernel path and the plain version with CUDA events.

Each phase prints one line. The last two lines are the kernels' JSON record
and ``{"ok": true, "device": {...}}``. Any failed phase exits non-zero
before those lines; so does a machine without CUDA.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

N_EVENTS = 65_536
N_LARGE = 1_048_576  # 512 MB of int16 waves: a real run chunk
WAVE_LEN = 256
ATOL, RTOL = 1e-3, 1e-4  # f32 outputs; ints, indices, counts, labels exact

# bench.make_batch(65536, 256, seed=0) through the JAX package's XLA chain
# (full_chain_step) with bench.py's config; tests/test_torch_chain_scan.py
# recomputes these with JAX
REF_S1_EVEN, REF_S2_ODD = 32768, 32767
REF_PEAK_OVERFLOW, REF_HIT_OVERFLOW = 1090, 0


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def ragged_batch(n: int, L: int, seed: int):
    """Mixed-polarity pulses (one event in five empty), ragged lengths,
    per-event integer baselines, polarity codes -1/0/+1."""
    rng = np.random.default_rng(seed)
    t = np.arange(L)
    c = rng.integers(50, L - 50, n)
    amp = rng.choice([300.0, -280.0], n) * (np.arange(n) % 5 != 0)
    width = rng.uniform(2, 20, n)
    waves = 1000.0 + amp[:, None] * np.exp(
        -((t[None, :] - c[:, None]) ** 2) / (2 * width[:, None] ** 2))
    waves += rng.normal(0, 3, waves.shape)
    return (np.round(waves).astype(np.int16),
            rng.integers(L // 2, L + 1, n).astype(np.int32),
            (1000 + rng.integers(-3, 4, n)).astype(np.float32),
            rng.choice(np.array([-1, 0, 1], np.int8), n))


def compare(ref: dict, out: dict, tag: str) -> float:
    """Exact ints, f32 within ATOL/RTOL; returns the largest f32 |diff|."""
    check(list(ref) == list(out), f"{tag}: keys {list(out)} != {list(ref)}")
    worst = 0.0
    for k in ref:
        a, b = ref[k].cpu().numpy(), out[k].cpu().numpy()
        check(a.dtype == b.dtype and a.shape == b.shape,
              f"{tag}/{k}: {b.dtype}{b.shape} != {a.dtype}{a.shape}")
        if np.issubdtype(a.dtype, np.integer):
            n_bad = int(np.sum(a != b))
            check(n_bad == 0, f"{tag}/{k}: {n_bad} integer mismatches")
        else:
            check(bool(np.isfinite(b).all()), f"{tag}/{k}: non-finite values")
            bad = ~np.isclose(b, a, atol=ATOL, rtol=RTOL)
            check(not bad.any(), f"{tag}/{k}: {int(bad.sum())} values outside "
                  f"atol {ATOL} / rtol {RTOL}")
            if a.size:
                worst = max(worst, float(np.max(np.abs(b.astype(np.float64) - a))))
    return worst


def median_ms(fn, iters: int = 7, warmup: int = 2) -> float:
    """Median CUDA-event time of fn(k), k a fresh shift per iteration."""
    for k in range(warmup):
        fn(k)
    times = []
    for k in range(warmup, warmup + iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(k)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> None:
    # ---- phase 1: device ---------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    sys.path.insert(0, str(ROOT))
    from bench import make_batch
    from waveformanalysis_tpu_torch.kernels._build import build
    from waveformanalysis_tpu_torch.models.full_chain import (
        ChainConfig,
        batch_from_numpy,
        full_chain_step,
    )
    from waveformanalysis_tpu_torch.ops import chain_scan_cuda as csc

    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {kind} x{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    print(smi, flush=True)

    # ---- phase 2: build ----------------------------------------------------
    built = build("chain_scan")
    regs = "; ".join(
        f"{p['function']}: {p.get('registers')} regs, "
        f"{p.get('spill_stores')} B spill stores, {p.get('spill_loads')} B spill loads"
        for p in built.ptxas)
    print(f"build: {built.path.name} in {built.seconds:.1f} s; {regs}", flush=True)

    # ---- phase 3: kernel against the plain version on the card ------------
    bench_cfg = ChainConfig(use_derivative=False, peak_height=80.0,
                            peak_prominence=50.0, peak_width=2.0)
    n, L = N_EVENTS, WAVE_LEN
    main_np = (make_batch(n, L, seed=0), np.full(n, L, np.int32),
               np.full(n, 1000.0, np.float32), np.full(n, 1, np.int8))
    ragged_np = ragged_batch(n, L, seed=1)
    dense_np = (np.round(1000 + np.random.default_rng(2).normal(0, 40, (n, L)))
                .astype(np.int16), ragged_np[1], np.full(n, 1000.0, np.float32),
                np.full(n, 1, np.int8))
    cases = [
        ("bench", bench_cfg, main_np),
        ("ragged_mixed_polarity", ChainConfig(use_derivative=False, peak_height=60.0,
                                              peak_prominence=30.0, peak_width=1.5),
         ragged_np),
        ("derivative", ChainConfig(use_derivative=True, peak_height=20.0,
                                   peak_prominence=5.0, peak_width=1.0,
                                   peak_distance=3), ragged_np),
        ("dense_noise_k16", ChainConfig(use_derivative=False, peak_height=10.0,
                                        peak_prominence=2.0, peak_width=0.5,
                                        peak_distance=1, max_peaks=16, max_hits=16,
                                        hit_threshold=5.0), dense_np),
    ]
    max_err = 0.0
    for tag, cfg, arrays in cases:
        batch = batch_from_numpy(*arrays, device=dev)
        before = csc.chain_scan_cuda.launches
        out = csc.chain_scan_cuda(*batch, cfg)
        torch.cuda.synchronize()
        check(csc.chain_scan_cuda.launches == before + 1, f"{tag}: kernel not launched")
        ref = full_chain_step(*batch, cfg)
        err = compare(ref, out, tag)
        max_err = max(max_err, err)
        print(f"parity {tag}: ok, max |f32 diff| {err:.3g}, "
              f"peak overflow {int(out['n_peak_overflow'])}, "
              f"labels {np.bincount(out['label'].cpu().numpy(), minlength=3).tolist()}",
              flush=True)

    # ---- phase 4: the main path --------------------------------------------
    batch = batch_from_numpy(*main_np, device=dev)
    step = csc.make_chain_scan(bench_cfg)
    csc.chain_scan_cuda.launches = 0
    out = step(*batch)
    torch.cuda.synchronize()
    launches = csc.chain_scan_cuda.launches
    check(launches >= 1, "main path did not launch the chain kernel")
    label = out["label"].cpu().numpy()
    for k, v in out.items():
        check(v.device == dev, f"main/{k} left the device")
        if v.dim():
            check(tuple(v.shape) == (n,), f"main/{k}: shape {tuple(v.shape)}")
        if v.dtype.is_floating_point:
            check(bool(torch.isfinite(v).all()), f"main/{k}: non-finite values")
    s1_even = int(np.sum(label[0::2] == 1))
    s2_odd = int(np.sum(label[1::2] == 2))
    po, ho = int(out["n_peak_overflow"]), int(out["n_hit_overflow"])
    check((s1_even, s2_odd, po, ho)
          == (REF_S1_EVEN, REF_S2_ODD, REF_PEAK_OVERFLOW, REF_HIT_OVERFLOW),
          f"main path counts (S1 even, S2 odd, peak ovf, hit ovf) = "
          f"{(s1_even, s2_odd, po, ho)}, JAX reference "
          f"{(REF_S1_EVEN, REF_S2_ODD, REF_PEAK_OVERFLOW, REF_HIT_OVERFLOW)}")
    print(f"main path: make_chain_scan on {n}x{L}: {launches} kernel launch(es); "
          f"S1 {s1_even}/{n // 2} even, S2 {s2_odd}/{n // 2} odd, "
          f"peak overflow {po}, hit overflow {ho} (= JAX reference)", flush=True)

    # ---- phase 5: times ----------------------------------------------------
    # plain, step, kernel alone, step, plain: the two versions in turns; each
    # iteration gets a fresh input (w + k, bl + k), the kernel alone a fresh
    # pre-transposed copy made outside its timed region
    times = {}
    lib = csc._library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for size in (N_EVENTS, N_LARGE):
        w, el, bl, pol = (t.repeat(size // n, *([1] * (t.dim() - 1))) for t in batch)
        shifted = [((w + k).t().contiguous(), bl + k) for k in range(9)]
        outs_k = {name: torch.empty(size, dtype=dt, device=dev) for name, dt in csc._OUTS}
        ptrs = csc._Outs(*(outs_k[name].data_ptr() for name, _ in csc._OUTS))
        prm = csc._params(bench_cfg, size, L)

        def kernel_only(k, shifted=shifted, ptrs=ptrs, prm=prm, el=el, pol=pol):
            w_t, bl_k = shifted[k]
            err = lib.wfa_chain_scan(w_t.data_ptr(), el.data_ptr(), bl_k.data_ptr(),
                                     pol.data_ptr(), ctypes.byref(ptrs),
                                     ctypes.byref(prm), stream)
            check(err == 0, f"kernel launch failed: cudaError {err}")

        def plain(k, w=w, el=el, bl=bl, pol=pol):
            full_chain_step(w + k, el, bl + k, pol, bench_cfg)

        def path(k, w=w, el=el, bl=bl, pol=pol):
            step(w + k, el, bl + k, pol)

        t_plain = median_ms(plain)
        t_step = median_ms(path)
        t_kern = median_ms(kernel_only)
        t_step2 = median_ms(path)
        t_plain2 = median_ms(plain)
        times[size] = (t_kern, t_plain)
        print(f"times {size}x{L} ({smi}), median ms of 7: plain {t_plain:.3f} / "
              f"{t_plain2:.3f} ({size / t_plain * 1e3:.0f} wf/s); make_chain_scan "
              f"step {t_step:.3f} / {t_step2:.3f} ({size / t_step * 1e3:.0f} wf/s); "
              f"kernel alone {t_kern:.3f} ({size / t_kern * 1e3:.0f} wf/s)", flush=True)
        del w, el, bl, pol, shifted, outs_k
        torch.cuda.empty_cache()

    # ---- phase 6: records --------------------------------------------------
    t_kern, t_plain = times[N_EVENTS]
    print(json.dumps({"kernels": [{
        "name": "chain_scan",
        "route": "cuda",
        "source": "waveformanalysis_tpu_torch/csrc/chain_scan.cu",
        "replaces": "waveformanalysis_tpu/ops/chain_scan_pallas.py:90",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": t_kern,
        "plain_ms": t_plain,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"# chip_smoke.py finished in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
