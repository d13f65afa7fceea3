#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the sources in this checkout (one
nvcc per source, all at once), holds each against its plain PyTorch
version on the card, and drives the port's two main paths:

- slice 1: ``make_chain_scan`` on bench.py's workload (65536 x 256), its
  S1/S2 and overflow counts against the JAX package's XLA chain (pinned by
  tests/test_torch_chain_scan.py);
- slice 2: the Context route ``ctx.get_data(run, ["s1_s2",
  "hit_threshold"])`` over the five S1/S2-cone plugins on bench.py's waves,
  every member table against the port's own CPU Context, and the table
  lengths and S1/S2 counts at 8192 events against the JAX package's
  (pinned by tests/test_torch_context_route.py).

Then it times the kernels alone and their plain versions (CUDA events) and
the Context route's warm per-run wall time at 65,536 and 1,048,576 events.

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
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

N_EVENTS = 65_536
N_LARGE = 1_048_576  # 512 MB of int16 waves: a real run chunk
N_ROUTE_REF = 8_192
WAVE_LEN = 256
ATOL, RTOL = 1e-3, 1e-4  # f32 outputs; ints, indices, counts, labels exact

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# bench.make_batch(65536, 256, seed=0) through the JAX package's XLA chain
# (full_chain_step) with bench.py's config; tests/test_torch_chain_scan.py
# recomputes these with JAX
REF_S1_EVEN, REF_S2_ODD = 32768, 32767
REF_PEAK_OVERFLOW, REF_HIT_OVERFLOW = 1090, 0

# the JAX package's Context route on bench.make_batch(8192, 256, seed=0)
# (st_waveforms_from_waves) with ROUTE_CONFIG: table lengths and S1/S2
# counts; tests/test_torch_context_route.py recomputes these with JAX
REF_ROUTE_8192 = {
    "basic_features": 8192, "hit": 9083, "hit_threshold": 14256,
    "waveform_width": 9083, "s1_s2": 9083, "n_s1": 4096, "n_s2": 4987,
}
# scripts/benchmark_suite.py config 7's plugin settings
ROUTE_CONFIG = {
    "hit": {"use_filtered": False, "use_derivative": False,
            "height": 80.0, "prominence": 50.0, "width": 2},
    "s1_s2": {"s1_width_range": (0.0, 30.0),
              "s2_width_range": (40.0, 10000.0)},
}
MEMBERS = ("basic_features", "hit", "hit_threshold", "waveform_width", "s1_s2")


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


def compare(ref: dict, out: dict, tag: str, mask=None, masked=()) -> float:
    """Exact ints, f32 within ATOL/RTOL; keys in ``masked`` only where
    ``mask`` is set. Returns the largest f32 |diff|."""
    check(list(ref) == list(out), f"{tag}: keys {list(out)} != {list(ref)}")
    worst = 0.0
    for k in ref:
        a, b = ref[k].cpu().numpy(), out[k].cpu().numpy()
        check(a.dtype == b.dtype and a.shape == b.shape,
              f"{tag}/{k}: {b.dtype}{b.shape} != {a.dtype}{a.shape}")
        if k in masked:
            a, b = a[mask], b[mask]
        if not np.issubdtype(a.dtype, np.floating):
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


def compare_tables(ref, out, tag: str) -> float:
    """Two Tables field by field (ints exact, f32 within tolerance)."""
    check(ref.field_names == out.field_names,
          f"{tag}: fields {out.field_names} != {ref.field_names}")
    return compare({f: torch.from_numpy(np.asarray(ref[f])) for f in ref.field_names},
                   {f: torch.from_numpy(np.asarray(out[f])) for f in out.field_names}, tag)


def median_ms(fn, iters: int = 7, warmup: int = 2) -> float:
    """Median CUDA-event time of fn(k), k a fresh index per iteration."""
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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, n_ops: float) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    float32 operations over the f32 peak."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def make_route_context(ctx_cls, plugins, storage_dir: str, device: str):
    ctx = ctx_cls(storage_dir=storage_dir,
                  config={"show_progress": False, "device": device})
    ctx.register(*(p() for p in plugins))
    ctx.set_config(ROUTE_CONFIG)
    return ctx


def main() -> None:
    # ---- phase 1: device ---------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    sys.path.insert(0, str(ROOT))
    from bench import make_batch
    from waveformanalysis_tpu_torch.context.context import Context
    from waveformanalysis_tpu_torch.kernels._build import build_all
    from waveformanalysis_tpu_torch.models.full_chain import (
        ChainConfig,
        batch_from_numpy,
        full_chain_step,
    )
    from waveformanalysis_tpu_torch.ops import chain_scan_cuda as csc
    from waveformanalysis_tpu_torch.ops import width_scan_cuda as wsc
    from waveformanalysis_tpu_torch.ops.hits import threshold_hits_batch
    from waveformanalysis_tpu_torch.ops.peaks import find_peaks_batch
    from waveformanalysis_tpu_torch.plugins.builtin.basic_features import BasicFeaturesPlugin
    from waveformanalysis_tpu_torch.plugins.builtin.hit_finder import ThresholdHitPlugin
    from waveformanalysis_tpu_torch.plugins.builtin.peak_finding import HitFinderPlugin
    from waveformanalysis_tpu_torch.plugins.builtin.s1_s2_classifier import S1S2ClassifierPlugin
    from waveformanalysis_tpu_torch.plugins.builtin.waveform_width import WaveformWidthPlugin
    from waveformanalysis_tpu_torch.testing.fixtures import st_waveforms_from_waves

    route_plugins = (BasicFeaturesPlugin, HitFinderPlugin, ThresholdHitPlugin,
                     WaveformWidthPlugin, S1S2ClassifierPlugin)
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {kind} x{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    print(smi, flush=True)

    # ---- phase 2: build (one nvcc per source, concurrently) ---------------
    t0 = time.perf_counter()
    built = build_all(["chain_scan", "peaks_scan", "hits_scan", "width_scan"])
    for name, b in built.items():
        regs = "; ".join(
            f"{p['function'][-40:]}: {p.get('registers')} regs, "
            f"{p.get('spill_stores')}/{p.get('spill_loads')} B spill st/ld"
            for p in b.ptxas)
        print(f"build {name}: {b.path.name} in {b.seconds:.1f} s; {regs}", flush=True)
    print(f"build wall {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 3: each kernel against its plain version on the card -------
    n, L = N_EVENTS, WAVE_LEN
    bench_cfg = ChainConfig(use_derivative=False, peak_height=80.0,
                            peak_prominence=50.0, peak_width=2.0)
    main_np = (make_batch(n, L, seed=0), np.full(n, L, np.int32),
               np.full(n, 1000.0, np.float32), np.full(n, 1, np.int8))
    ragged_np = ragged_batch(n, L, seed=1)
    dense_np = (np.round(1000 + np.random.default_rng(2).normal(0, 40, (n, L)))
                .astype(np.int16), ragged_np[1], np.full(n, 1000.0, np.float32),
                np.full(n, 1, np.int8))
    max_err = {"chain_scan": 0.0, "peaks_scan": 0.0, "hits_scan": 0.0, "width_scan": 0.0}

    chain_cases = [
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
    for tag, cfg, arrays in chain_cases:
        batch = batch_from_numpy(*arrays, device=dev)
        before = csc.chain_scan_cuda.launches
        out = csc.chain_scan_cuda(*batch, cfg)
        torch.cuda.synchronize()
        check(csc.chain_scan_cuda.launches == before + 1, f"{tag}: kernel not launched")
        err = compare(full_chain_step(*batch, cfg), out, f"chain {tag}")
        max_err["chain_scan"] = max(max_err["chain_scan"], err)
        print(f"parity chain_scan {tag}: ok, max |f32 diff| {err:.3g}, "
              f"peak overflow {int(out['n_peak_overflow'])}, "
              f"labels {np.bincount(out['label'].cpu().numpy(), minlength=3).tolist()}",
              flush=True)

    # detection signals as the hit / hit_threshold device stages form them
    w_main = torch.from_numpy(main_np[0]).to(dev)
    sig_main = w_main.float() - 1000.0
    vl_main = torch.full((n,), L, dtype=torch.int32, device=dev)
    rw, rel, rbl, rpol = (torch.from_numpy(a).to(dev) for a in ragged_np)
    rsign = torch.where(rpol > 0, 1.0, -1.0)
    sig_rag = rsign[:, None] * (rw.float() - rbl[:, None])
    sig_der = rsign[:, None] * (rw[:, 1:].float() - rw[:, :-1].float())
    peak_fields = ("peak_value", "prominence", "left_ips", "right_ips", "widths",
                   "left_bases", "right_bases")
    peak_cases = [
        ("bench_config7_k8", sig_main, vl_main,
         dict(height=80.0, prominence=50.0, width=2.0, distance=2, max_peaks=8)),
        ("ragged_d3_k16", sig_rag, rel,
         dict(height=60.0, prominence=30.0, width=1.5, distance=3, max_peaks=16)),
        ("derivative_k8", sig_der, (rel - 1).clamp(min=0),
         dict(height=20.0, prominence=5.0, width=1.0, distance=3, max_peaks=8)),
    ]
    for tag, sig, vl, kw in peak_cases:
        before = csc.find_peaks_scan.launches
        out = csc.find_peaks_scan(sig, valid_length=vl, **kw)
        torch.cuda.synchronize()
        check(csc.find_peaks_scan.launches == before + 1, f"peaks {tag}: kernel not launched")
        ref = find_peaks_batch(sig, valid_length=vl, **kw)
        err = compare(ref, out, f"peaks {tag}", ref["valid"].cpu().numpy(), peak_fields)
        max_err["peaks_scan"] = max(max_err["peaks_scan"], err)
        print(f"parity peaks_scan {tag}: ok, {int(ref['valid'].sum())} peaks, "
              f"max |f32 diff| {err:.3g}", flush=True)

    hit_fields = ("position", "height", "integral", "seg_start", "seg_end",
                  "run_start", "run_end")
    rng = np.random.default_rng(3)
    thr_evt = torch.from_numpy(rng.uniform(20, 60, n).astype(np.float32)).to(dev)
    sig_edge = sig_rag.clone()
    sig_edge[:, -6:] += 400.0  # runs that reach the wave end
    sig_edge[::3, 40:43] += 400.0
    hit_cases = [
        ("bench_thr10_k32", sig_main, torch.full((n,), 10.0, device=dev), vl_main,
         dict(max_hits=32)),
        ("ragged_per_event_thr_k8", sig_rag, thr_evt, rel,
         dict(max_hits=8, left_extension=2, right_extension=3)),
        ("runs_to_boundary_k2", sig_edge, thr_evt, vl_main,
         dict(max_hits=2, left_extension=1, right_extension=4)),
    ]
    for tag, sig, thr, vl, kw in hit_cases:
        before = csc.threshold_hits_scan.launches
        out = csc.threshold_hits_scan(sig, thr, vl, **kw)
        torch.cuda.synchronize()
        check(csc.threshold_hits_scan.launches == before + 1, f"hits {tag}: kernel not launched")
        ref = threshold_hits_batch(sig, thr, vl, **kw)
        err = compare(ref, out, f"hits {tag}", ref["valid"].cpu().numpy(), hit_fields)
        max_err["hits_scan"] = max(max_err["hits_scan"], err)
        print(f"parity hits_scan {tag}: ok, {int(ref['valid'].sum())} runs, max run "
              f"count {int(ref['n_runs'].max())}, max |f32 diff| {err:.3g}", flush=True)

    slots = csc.find_peaks_scan(sig_main, valid_length=vl_main, height=80.0,
                                prominence=50.0, width=2.0, distance=2, max_peaks=32)
    pos_main = slots["position"]
    bl_main = w_main.float()[:, :50].sum(dim=1) / 50
    pos_odd = torch.from_numpy(rng.integers(-3, L + 3, (n, 4)).astype(np.int32)).to(dev)
    width_cases = [
        ("k2_slots_k32_int16", w_main, bl_main, pos_main, True),
        ("k2_slots_k32_f32", w_main.float(), bl_main, pos_main, True),
        ("odd_positions_no_interp", rw, bl_main, pos_odd, False),
    ]
    for tag, w, bl, pos, interp in width_cases:
        before = wsc.width_crossings_scan.launches
        out = wsc.width_crossings_scan(w, bl, pos, 0.1, 0.9, 0.9, 0.1, interp)
        torch.cuda.synchronize()
        check(wsc.width_crossings_scan.launches == before + 1, f"width {tag}: kernel not launched")
        ref = wsc.width_crossings_plain(w, bl, pos, 0.1, 0.9, 0.9, 0.1, interp)
        err = compare(ref, out, f"width {tag}")
        max_err["width_scan"] = max(max_err["width_scan"], err)
        print(f"parity width_scan {tag}: ok, {int((pos >= 0).sum())} occupied slots, "
              f"max |f32 diff| {err:.3g}", flush=True)
    del slots, sig_rag, sig_der, sig_edge

    # ---- phase 4: main path of slice 1 (make_chain_scan) ------------------
    # each main path runs with every kernel's count set to 0 just before it
    kernels = {"chain_scan": csc.chain_scan_cuda, "peaks_scan": csc.find_peaks_scan,
               "hits_scan": csc.threshold_hits_scan, "width_scan": wsc.width_crossings_scan}
    batch = batch_from_numpy(*main_np, device=dev)
    step = csc.make_chain_scan(bench_cfg)
    for fn in kernels.values():
        fn.launches = 0
    out = step(*batch)
    torch.cuda.synchronize()
    launches = {"chain_scan": csc.chain_scan_cuda.launches}
    check(launches["chain_scan"] >= 1, "main path did not launch the chain kernel")
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
    print(f"main path 1: make_chain_scan on {n}x{L}: {launches['chain_scan']} kernel "
          f"launch(es); S1 {s1_even}/{n // 2} even, S2 {s2_odd}/{n // 2} odd, "
          f"peak overflow {po}, hit overflow {ho} (= JAX reference)", flush=True)

    # ---- phase 5: main path of slice 2 (the Context route) ----------------
    route_kernels = ("peaks_scan", "hits_scan", "width_scan")
    st_main = st_waveforms_from_waves(main_np[0])
    with tempfile.TemporaryDirectory() as tmp:
        ctx = make_route_context(Context, route_plugins, f"{tmp}/cuda", "cuda")
        ctx.inject_data("r", "st_waveforms", st_main)
        for fn in kernels.values():
            fn.launches = 0
        ctx.get_data("r", ["s1_s2", "hit_threshold"])
        torch.cuda.synchronize()
        launches.update({name: kernels[name].launches for name in route_kernels})
        for name in route_kernels:
            check(launches[name] >= 1, f"the Context route did not launch {name}")
        check("fusion.wave_chain.compute" in ctx.profiler.stats(),
              "the Context route did not run the fused program")
        gpu_tables = {m: ctx.get_data("r", m) for m in MEMBERS}
        ctx.flush_saves()

        t_cpu = time.perf_counter()
        ctx_cpu = make_route_context(Context, route_plugins, f"{tmp}/cpu", "cpu")
        ctx_cpu.inject_data("r", "st_waveforms", st_main)
        ctx_cpu.get_data("r", ["s1_s2", "hit_threshold"])
        cpu_tables = {m: ctx_cpu.get_data("r", m) for m in MEMBERS}
        ctx_cpu.flush_saves()
        t_cpu = time.perf_counter() - t_cpu
        route_err = max(compare_tables(cpu_tables[m], gpu_tables[m], f"route/{m}")
                        for m in MEMBERS)
        lab = np.asarray(gpu_tables["s1_s2"]["label"])
        print(f"main path 2: Context get_data(['s1_s2', 'hit_threshold']) on {n}x{L}: "
              f"launches {launches}; tables "
              f"{ {m: len(t) for m, t in gpu_tables.items()} }, S1 {int(np.sum(lab == 1))}, "
              f"S2 {int(np.sum(lab == 2))}; every member table = the CPU Context's "
              f"(max |f32 diff| {route_err:.3g}; CPU route {t_cpu:.1f} s)", flush=True)
        del ctx, ctx_cpu, gpu_tables, cpu_tables

        ctx = make_route_context(Context, route_plugins, f"{tmp}/ref", "cuda")
        ctx.inject_data("r", "st_waveforms",
                        st_waveforms_from_waves(make_batch(N_ROUTE_REF, L, seed=0)))
        ctx.get_data("r", ["s1_s2", "hit_threshold"])
        got = {m: len(ctx.get_data("r", m)) for m in MEMBERS}
        lab = np.asarray(ctx.get_data("r", "s1_s2")["label"])
        got.update(n_s1=int(np.sum(lab == 1)), n_s2=int(np.sum(lab == 2)))
        ctx.flush_saves()
        check(got == REF_ROUTE_8192, f"route at {N_ROUTE_REF} events: {got}, "
              f"JAX reference {REF_ROUTE_8192}")
        print(f"main path 2 at {N_ROUTE_REF}x{L}: {got} (= JAX reference)", flush=True)

    # ---- phase 6: kernel times ---------------------------------------------
    # kernels alone on pre-transposed inputs (several copies in turn, more
    # bytes than the 50 MB L2 holds, so each launch reads cold input), with
    # the plain versions on the same inputs; slot capacity 32, the plugins'
    # default and the Context route's
    times, bounds = {}, {}
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib_chain = csc._library()
    lib_peaks = csc._peaks_library()
    lib_hits = csc._hits_library()
    lib_width = wsc._library()
    K = 32
    for size in (N_EVENTS, N_LARGE):
        reps = size // n
        w = w_main.repeat(reps, 1)
        sig = w.float() - 1000.0
        el = torch.full((size,), L, dtype=torch.int32, device=dev)
        bl = torch.full((size,), 1000.0, device=dev)
        pol = torch.ones(size, dtype=torch.int8, device=dev)
        thr = torch.full((size,), 10.0, device=dev)
        n_copies = 4 if size == N_EVENTS else 2
        sig_t = [(sig + k).t().contiguous() for k in range(n_copies)]
        w_t = [(w + k).t().contiguous() for k in range(n_copies)]

        # K1: plain, step, kernel alone, step, plain
        outs1 = {name: torch.empty(size, dtype=dt, device=dev) for name, dt in csc._OUTS}
        ptrs1 = csc._Outs(*(outs1[name].data_ptr() for name, _ in csc._OUTS))
        prm1 = csc._params(bench_cfg, size, L)

        def k1(k):
            err = lib_chain.wfa_chain_scan(w_t[k % n_copies].data_ptr(), el.data_ptr(),
                                           bl.data_ptr(), pol.data_ptr(), ctypes.byref(ptrs1),
                                           ctypes.byref(prm1), stream)
            check(err == 0, f"chain kernel launch failed: cudaError {err}")

        t_plain = median_ms(lambda k: full_chain_step(w + k, el, bl + k, pol, bench_cfg))
        t_step = median_ms(lambda k: step(w + k, el, bl + k, pol))
        t_k1 = median_ms(k1)
        t_step2 = median_ms(lambda k: step(w + k, el, bl + k, pol))
        t_plain2 = median_ms(lambda k: full_chain_step(w + k, el, bl + k, pol, bench_cfg))
        times[("chain_scan", size)] = (t_k1, t_plain)
        # operations: ~20 per sample in the features / runs / candidate
        # pass every sample goes through (a lower count: the slot passes'
        # work depends on the data); the same reading for K2-K4 below
        bounds[("chain_scan", size)] = bound(
            nbytes(w, el, bl, pol, *outs1.values()), 20.0 * size * L)
        print(f"times chain_scan {size}x{L} ({smi}), median ms of 7: plain {t_plain:.3f} / "
              f"{t_plain2:.3f}; make_chain_scan step {t_step:.3f} / {t_step2:.3f} "
              f"({size / t_step * 1e3:.0f} wf/s); kernel alone {t_k1:.3f} "
              f"({size / t_k1 * 1e3:.0f} wf/s)", flush=True)
        del outs1

        # K2
        kw2 = dict(height=80.0, prominence=50.0, width=2.0, distance=2, max_peaks=K)
        outs2 = csc._tables(csc._PEAKS_OUTS, size, K, dev)
        ptrs2 = csc._PeaksOut(*(outs2[name].data_ptr() for name, _ in csc._PEAKS_OUTS))
        prm2 = csc._PeaksParams(n=size, L=L, K=K, distance=2, height=80.0,
                                prominence=50.0, width=2.0, rel_height=0.5)

        def k2(k):
            err = lib_peaks.wfa_peaks_scan(sig_t[k % n_copies].data_ptr(), el.data_ptr(),
                                           ctypes.byref(ptrs2), ctypes.byref(prm2), stream)
            check(err == 0, f"peaks kernel launch failed: cudaError {err}")

        t_k2 = median_ms(k2)
        t_w2 = median_ms(lambda k: csc.find_peaks_scan(sig + k, valid_length=el, **kw2))
        t_p2 = median_ms(lambda k: find_peaks_batch(sig + k, valid_length=el, **kw2),
                         iters=5, warmup=1)
        times[("peaks_scan", size)] = (t_k2, t_p2)
        bounds[("peaks_scan", size)] = bound(nbytes(sig, el, *outs2.values()), 8.0 * size * L)
        print(f"times peaks_scan {size}x{L} K={K} ({smi}): kernel alone {t_k2:.3f} ms, "
              f"wrapper (with transpose) {t_w2:.3f} ms, plain find_peaks_batch "
              f"{t_p2:.3f} ms", flush=True)
        pos = outs2["position"].clone()
        del outs2

        # K3
        outs3 = csc._tables(csc._HITS_OUTS, size, K, dev)
        ptrs3 = csc._HitsOut(*(outs3[name].data_ptr() for name, _ in csc._HITS_OUTS))
        prm3 = csc._HitsParams(n=size, L=L, K=K, left_extension=2, right_extension=2)

        def k3(k):
            err = lib_hits.wfa_hits_scan(sig_t[k % n_copies].data_ptr(), thr.data_ptr(),
                                         el.data_ptr(), ctypes.byref(ptrs3),
                                         ctypes.byref(prm3), stream)
            check(err == 0, f"hits kernel launch failed: cudaError {err}")

        t_k3 = median_ms(k3)
        t_w3 = median_ms(lambda k: csc.threshold_hits_scan(sig + k, thr, el, max_hits=K))
        t_p3 = median_ms(lambda k: threshold_hits_batch(sig + k, thr, el, max_hits=K),
                         iters=5, warmup=1)
        times[("hits_scan", size)] = (t_k3, t_p3)
        bounds[("hits_scan", size)] = bound(nbytes(sig, thr, el, *outs3.values()),
                                            4.0 * size * L)
        print(f"times hits_scan {size}x{L} K={K} ({smi}): kernel alone {t_k3:.3f} ms, "
              f"wrapper (with transpose) {t_w3:.3f} ms, plain threshold_hits_batch "
              f"{t_p3:.3f} ms", flush=True)
        del outs3, sig_t

        # K4 on K2's slots (int16 waves, as in the Context route)
        blw = w.float()[:, :50].sum(dim=1) / 50
        outs4 = {key: torch.empty((size, K), dtype=torch.int32 if key.endswith("_idx")
                                  else torch.float32, device=dev) for key in wsc.OUT_KEYS}
        ptrs4 = wsc._WidthOut(*(outs4[key].data_ptr() for key in wsc.OUT_KEYS))
        prm4 = wsc._WidthParams(n=size, L=L, K=K, interpolation=1, rise_low=0.1,
                                rise_high=0.9, fall_high=0.9, fall_low=0.1)

        def k4(k):
            err = lib_width.wfa_width_scan(w_t[k % n_copies].data_ptr(), 0, blw.data_ptr(),
                                           pos.data_ptr(), ctypes.byref(ptrs4),
                                           ctypes.byref(prm4), stream)
            check(err == 0, f"width kernel launch failed: cudaError {err}")

        t_k4 = median_ms(k4)
        t_w4 = median_ms(lambda k: wsc.width_crossings_scan(w + k, blw, pos, 0.1, 0.9, 0.9, 0.1))
        t_p4 = median_ms(lambda k: wsc.width_crossings_plain(w + k, blw, pos, 0.1, 0.9, 0.9, 0.1),
                         iters=5, warmup=1)
        times[("width_scan", size)] = (t_k4, t_p4)
        bounds[("width_scan", size)] = bound(nbytes(w, blw, pos, *outs4.values()),
                                             2.0 * size * L)
        print(f"times width_scan {size}x{L} K={K} ({smi}): kernel alone {t_k4:.3f} ms, "
              f"wrapper (with transpose) {t_w4:.3f} ms, plain width_crossings_plain "
              f"{t_p4:.3f} ms", flush=True)
        del w, sig, w_t, outs4, pos
        torch.cuda.empty_cache()
    for (name, size), (ms, _) in times.items():
        b_ms, b_by = bounds[(name, size)]
        print(f"bound {name} {size}x{L}: {b_ms:.4f} ms by {b_by}; kernel at "
              f"{100 * b_ms / ms:.1f} % of it", flush=True)

    # ---- phase 7: the Context route's warm per-run wall time --------------
    # a fresh run id and fresh waves per run (results are cached per run);
    # 1 cold run, then the median of 3; flush_saves() after each run
    seed = 100
    with tempfile.TemporaryDirectory() as tmp:
        ctx = make_route_context(Context, route_plugins, tmp, "cuda")
        for size in (N_EVENTS, N_LARGE):
            walls, flushes, phases = [], [], []
            for i in range(4):
                seed += 1
                rid = f"t{size}_{i}"
                ctx.inject_data(rid, "st_waveforms",
                                st_waveforms_from_waves(make_batch(size, L, seed=seed)))
                ctx.profiler.reset()
                t0 = time.perf_counter()
                res = ctx.get_data(rid, ["s1_s2", "hit_threshold"])
                walls.append(time.perf_counter() - t0)
                check(len(res["s1_s2"]) > 0, f"route {rid}: no s1_s2 rows")
                phases.append({k.split("fusion.single.", 1)[1]: v["total_s"]
                               for k, v in ctx.profiler.stats().items()
                               if k.startswith("fusion.single.")})
                t0 = time.perf_counter()
                ctx.flush_saves()
                flushes.append(time.perf_counter() - t0)
            med = statistics.median(walls[1:])
            med_ph = {k: round(statistics.median(p[k] for p in phases[1:]) * 1e3, 1)
                      for k in phases[1]}
            print(f"route {size}x{L} ({smi}): cold {walls[0]:.3f} s; warm median of 3 "
                  f"{med * 1e3:.1f} ms = {size / med:.0f} waveforms/s (runs "
                  f"{[round(x * 1e3, 1) for x in walls[1:]]} ms); fusion.single phases "
                  f"ms {med_ph}; flush_saves median "
                  f"{statistics.median(flushes[1:]) * 1e3:.1f} ms", flush=True)

        # one more warm run at 65,536 under torch.profiler: device time by
        # kernel and the device's idle share of the call (not in the medians)
        from torch.profiler import ProfilerActivity, profile

        ctx.inject_data("prof", "st_waveforms",
                        st_waveforms_from_waves(make_batch(N_EVENTS, L, seed=seed + 1)))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ctx.get_data("prof", ["s1_s2", "hit_threshold"])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        ctx.flush_saves()
        # device-side events only (kernels, copies, sets): the aten ops
        # above them repeat their time
        rows = [(e.self_device_time_total / 1e3, e.count, e.key)
                for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        rows = sorted((r for r in rows if r[0] > 0), reverse=True)
        dev_ms = sum(r[0] for r in rows)
        print(f"route profile {N_EVENTS}x{L} ({smi}): wall {wall_ms:.1f} ms under the "
              f"profiler, device busy {dev_ms:.2f} ms, idle share "
              f"{1 - dev_ms / wall_ms:.3f}; top device ops (ms, calls): "
              f"{[(round(t, 3), c, k[:48]) for t, c, k in rows[:10]]}", flush=True)

    # ---- phase 8: guard and records ----------------------------------------
    leaked = sorted(m for m in sys.modules if m.split(".")[0] == "waveformanalysis_tpu")
    check(not leaked, f"the JAX package was imported: {leaked}")
    check(not any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules),
          "jax was imported")
    replaces = {
        "chain_scan": "waveformanalysis_tpu/ops/chain_scan_pallas.py:90",
        "peaks_scan": "waveformanalysis_tpu/ops/chain_scan_pallas.py:920",
        "hits_scan": "waveformanalysis_tpu/ops/chain_scan_pallas.py:1238",
        "width_scan": "waveformanalysis_tpu/ops/width_scan_pallas.py:59",
    }
    records = []
    for name in replaces:
        ms, plain_ms = times[(name, N_EVENTS)]
        b_ms, b_by = bounds[(name, N_EVENTS)]
        records.append({
            "name": name,
            "route": "cuda",
            "source": f"waveformanalysis_tpu_torch/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": max_err[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,  # no PyTorch call computes these functions
        })
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"# chip_smoke.py finished in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
