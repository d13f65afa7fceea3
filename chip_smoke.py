#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the sources in this checkout (one
nvcc per source, all at once), holds each against its plain PyTorch
version on the card, and drives the port's main paths:

- slice 1: ``make_chain_scan`` on bench.py's workload (65536 x 256), its
  S1/S2 and overflow counts against the JAX package's XLA chain (pinned by
  tests/test_torch_chain_scan.py);
- slice 2: the Context route ``ctx.get_data(run, ["s1_s2",
  "hit_threshold"])`` over the five S1/S2-cone plugins on bench.py's waves,
  every member table against the port's own CPU Context, and the table
  lengths and S1/S2 counts at 8192 events against the JAX package's
  (pinned by tests/test_torch_context_route.py);
- slice 3: the same request with ``FilteredWaveformsPlugin`` registered,
  route A (the defaults: SG, only ``hit`` reads ``filtered_waveforms``) and
  route B (the Butterworth bandpass through the zero-phase kernel, every
  member on ``filtered_waveforms``), each member table and the filtered
  waves against the port's CPU Context, and the counts at 4096 events
  against the JAX package's (pinned by tests/test_torch_filtered_route.py);
- slice 4: the facade's ``make_chain_tile`` (the tile chain, one warp per
  event on the event-major rows) on bench.py's workload, with slice 1's
  JAX counts, then the fused-chain demo (plain, tile and scan chains agree);
- slice 8: the path from DAQ files, ``ctx.get_data(run, ["df_paired",
  "hit_grouped", "s1_s2"])`` under the default profile on 262,144
  waveforms of VX2730 files it writes (the g++ CSV decoder, st_waveforms
  against the written arrays, K2 and K3 launched, the memory held flat),
  the card's tables of a 16,384 run against the port's CPU Context and the
  counts of a 4,096 run against the JAX package's (pinned by
  tests/test_torch_events.py); the grouping ops' device backend against
  the host backend at 262,144 and 1,048,576 rows; the tutorial;
- slice 9: records ingest on the same files, ``get_data(run,
  RECORDS_REQUEST)`` with ``wave_source="records"`` on route A (the
  defaults: hit on the SG-filtered pool, K2; the rest fused over the pool,
  K3) and route B (the Butterworth pool through K5, bit for bit against the
  plain filter on the card, every member fused), each cold and 3 warm
  runs with the records build's phases, the memory held flat and a
  profile of route A (device idle share); a build in parts against one
  part; the card's tables of a 16,384 run against the port's CPU Context
  and the counts of a 4,096 run against the JAX package's (pinned by
  tests/test_torch_records.py); the records route from 262,144 V1725
  records and ``st_waveforms`` with ``device_unpack=True`` against the
  host walk, bit for bit, both timed; the records sort order and padded
  matrix, host against device, at 262,144 and 1,048,576 rows; the two
  records examples;
- slice 10: the batched multi-run path, ``ctx.get_data_batched(runs,
  names)``: slice 2's request over 16 runs of 65,536 injected waveforms in
  one fused program (K2, K3 and K4 launched once for the group), every
  run's tables = per-run ``get_data`` bit for bit, the batched wall against
  16 per-run calls in turns with the memory held flat and the peak of a
  call, two 8,192 runs against the port's CPU Context; the ingest request
  over 4 runs linked to slice 8's files (= per run, timed in turns),
  ``BatchProcessor`` with the ``device`` executor (``on_error="raise"``)
  and the thread executor; the batched multi-run demo. Phase 3 holds K2,
  K3 and K4 on a batched group's matrix too (runs of 256 and 200 samples,
  zero-length padding rows; K2 and K3 at K = 8, 16 and 32);
- slice 11, chunked streaming on slice 8's files under
  ``get_profile("streaming")``: ``get_stream(run, name,
  executor_type="device")`` for basic_features, hit, hit_threshold and
  waveform_width_integral (K2 and K3 once per chunk), each merged stream =
  the static table and the device executor = the host serial engine, bit
  for bit; ``signal_peaks_stream`` persisted chunk by chunk and read back
  from the cache; the memory held flat; a 16,384 run's chunks against the
  port's CPU Context; the streaming demo;
- slice 12, the surface on slice 8's files: ``PipelineServer`` on a
  thread answering ``get_data`` (cold, warm, a cache hit) and
  ``get_data_batched`` through its socket, with the memory held flat;
  ``python -m waveformanalysis_tpu_torch.server`` as its own process on
  the card, whose persisted tables a second Context loads with no compute,
  equal to the port's CPU Context's; ``waveform-process`` writing
  df_paired to CSV, equal to the card's table; ``waveform-cache`` info,
  diagnose and a dry-run clean over the server's storage;
- slice 13, the user utilities on slice 8's files: ``parse_and_stack_files``
  (= the reader, file by file), ``WaveformPreviewer``, the event filters on
  the card's df_events (bit for bit the CPU Context's on a 16,384 run),
  ``StraxContextAdapter.get_array(run, "hit")`` and
  ``create_interactive_browser`` (K2 once each), the records view, the
  lineage plot, a user plugin found by ``PluginLoader`` and hot-reloaded
  (K2 again after the edit), with the memory held flat; the renders run
  where matplotlib is installed;
- slice 14, a mesh of 8 shards (one card holds all 8; several cards hold
  them in blocks): ``make_sharded_chain_scan`` / ``make_sharded_chain_tile``
  on 1,048,576 events (K1 / K7 once a shard, = the one-device steps bit for
  bit, timed beside them) and ``make_sharded_chain``; the halo pipeline;
  ``sharded_time_sort`` against ``np.lexsort`` and the records mesh merge of
  slice 8's files against the host merge; a mesh Context on 262,144
  injected waveforms (K2-K4 once a shard, = the one-device Context bit for
  bit, memory flat) and ``get_data_batched`` on the mesh; the ``hit`` and
  ``signal_peaks_stream`` streams of the files on the mesh and
  ``merge_stream(backend="device")``; then the port's seventeen examples,
  eight processes at a time;
- slice 15, ``models.pipeline``'s fused feature step (plain torch, no
  kernel) on bench.py's waves with mixed polarity and ragged lengths, the
  card's outputs against the CPU's;
- slice 16, the port's tools: the random-config chain fuzz
  (scripts/fuzz_chain_configs_torch.py, K1 and K7 against the plain chain
  on 14 configs of 256 events) and the install check
  (scripts/verify_install_torch.py) on the card.

The chain (K1), find_peaks (K2), threshold-hit (K3) and width-crossing
(K4) kernels run one warp per event on the event-major rows as well
(slices 5 and 6); phase 3 holds them at K = 32 and more, on unaligned
rows and on rows read from global memory (L = 65,536). The tile chain (K7)
runs K1's warp passes on a float32 signal row, and the zero-phase filter
(K5) reads and writes the event-major rows through a shared-memory tile;
phase 3 holds K7 on rows too long for that row too, and K5 bit for bit on
S = 1 to 6, odd n, L = 250, int16 input and rows too long for its tile.
The one-direction filter (K6) walks the event-major rows in 128-sample
chunks, forward or in reverse; phase 3 holds it bit for bit on S = 1, 3, 4
and 6, odd n, rows of 251, 310 and 4,096 samples, and its two-pass
composition bit for bit against K5, with no transposing copy or flip among
its operations.
Routes A and B also check that once get_data returns, no cached table
holds a column on the card (the filtered waves come back as a host
matrix).

Then it times the kernels alone and their plain versions (CUDA events) and
the Context routes' warm per-run wall time at 65,536 and 1,048,576 events
(route B with and without moving its device columns to the host, in turns);
slice 8's route and the grouping backends are timed in their own phases.

Each phase prints one line (phase 3 one line per kernel). The last two
lines are the kernels' JSON record
and ``{"ok": true, "device": {...}}``. Any failed phase exits non-zero
before those lines; so does a machine without CUDA.
"""

from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

N_EVENTS = 65_536
N_LARGE = 1_048_576  # 512 MB of int16 waves: a real run chunk
N_ROUTE_REF = 8_192
WAVE_LEN = 256
LONG_ROW = 65_536  # K2 / K4 rows too long for shared memory (the long-row mode)
CHAIN_LONG_ROW = 40_000  # K7 rows too long for its float32 signal row
ATOL, RTOL = 1e-3, 1e-4  # f32 outputs; ints, indices, counts, labels exact

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# the same units issuing a separate multiply and add (the IIR kernels are
# built with --fmad=false, so no operation pairs into an FMA)
F32_NONFMA_OPS_PER_S = F32_OPS_PER_S / 2

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

# slice 3: (plugin config, st_waveforms baseline) of the two routes through
# filtered_waveforms (tests/test_torch_filtered_route.py documents both)
_HIT = {"use_derivative": False, "height": 80.0, "prominence": 50.0, "width": 2}
_S1S2 = ROUTE_CONFIG["s1_s2"]
FILTER_ROUTES = {
    # the defaults: SG (window 11, poly 2), only hit on filtered_waveforms
    "A": ({"hit": _HIT, "s1_s2": _S1S2}, 1000.0),
    # the Butterworth bandpass, every member on filtered_waveforms; the
    # bandpass removes the DC level and hit subtracts the st baseline
    "B": ({"filtered_waveforms": {"filter_type": "BW", "filter_order": 4,
                                  "lowcut": 0.002, "highcut": 0.1, "fs": 0.5},
           "basic_features": {"wave_source": "filtered_waveforms"},
           "hit": _HIT,
           "hit_threshold": {"wave_source": "filtered_waveforms"},
           "waveform_width": {"use_filtered": True},
           "s1_s2": _S1S2}, 0.0),
}
# members computed outside the fused program (the JAX package's plan)
FILTER_STANDALONE = {"A": {"hit", "waveform_width", "s1_s2"}, "B": set()}
N_FILTER_REF = 4096
# the JAX routes on bench.make_batch(4096, 256, seed=0); route B filters with
# the JAX package's Pallas kernel in interpret mode;
# tests/test_torch_filtered_route.py recomputes these with JAX
REF_FILTER_ROUTES = {
    "A": {"basic_features": 4096, "hit": 4096, "hit_threshold": 7108,
          "waveform_width": 4096, "s1_s2": 4096, "n_s1": 2048, "n_s2": 2048},
    "B": {"basic_features": 4096, "hit": 4096, "hit_threshold": 7475,
          "waveform_width": 4096, "s1_s2": 4096, "n_s1": 2048, "n_s2": 2048},
}
# (order, lowcut, highcut, fs) in GHz of the kernels' parity and timing cases
FILTER_DESIGNS = {
    "route_b": (4, 0.002, 0.1, 0.5),
    "config3": (2, 0.1, 0.2, 0.5),  # scripts/benchmark_suite.py:154
    "order3": (3, 0.01, 0.15, 0.5),
    "order1": (1, 0.01, 0.2, 0.5),
    "order6": (6, 0.01, 0.2, 0.5),  # two chunks of four sections
}
FILTER_LONG_ROW = 4_096  # K5 rows too long for its shared-memory tile
SG_RTOL = 1e-5  # SG on the card vs the CPU (docs/PARITY.md:34)
BW_WAVE_ATOL = 5e-4  # filtered waves, CUDA vs CPU Context (docs/PARITY.md:34)
# route B's peak device memory for one 1,048,576 x 256 run, estimated before
# the first timed run: the int16 st matrix 0.5 GB + the f32 filtered matrix
# 1.0 + one channel group's filter temporaries 1.3 + the fused program's
# signals and time-major copies 3.0 + slot tables 4.1 + their compaction 2.7
ROUTE_B_PEAK_ESTIMATE_GB = 12.6

# slice 8: the path from DAQ files. A VX2730 run of 2 channels x 4 files x
# n / 8 rows of WAVE_LEN samples (write_ingest_run), read through the
# default profile; channel 1 is staggered inside df_events' 100 ns window
N_INGEST = 262_144  # about one records shard (the JAX records plugin shards at 250k events)
N_INGEST_CPU = 16_384  # the card's tables against the port's CPU Context
N_INGEST_REF = 4_096  # row counts against the JAX package's
INGEST_FILES = 4
INGEST_DT_PS = 10_000_000  # between a channel's rows
INGEST_OFFSET_PS = 20_000  # channel 1's stagger
INGEST_REQUEST = ["df_paired", "hit_grouped", "s1_s2"]
INGEST_TABLES = ("st_waveforms", "df", "df_events", "df_paired", "hit", "hit_threshold",
                 "hit_grouped")
# the JAX package's default profile (tpu_default) on write_ingest_run(...,
# N_INGEST_REF, seed=0): row counts and S1/S2 counts;
# tests/test_torch_events.py recomputes these with JAX
REF_INGEST_4096 = {
    "st_waveforms": 4096, "df": 4096, "df_events": 2048, "df_paired": 2048, "hit": 4096,
    "hit_threshold": 6218, "hit_grouped": 2302, "n_s1": 2048, "n_s2": 2048,
}
# the device-grouping phase's df sizes
N_GROUPING = (262_144, 1_048_576)

# slice 10: a batched group's matrix in phase 3 (runs of these events x L,
# concatenated and padded with zero-length rows to a multiple of the
# bucket, as WaveChainFusion._dispatch_group lays them out), and the
# batched phases' sizes
BATCH_RUNS = ((50_000, 256), (65_536, 200), (17_000, 256))
BATCH_BUCKET = 4096
N_BATCH_RUNS = 16  # the batched injected phase: 16 runs of N_EVENTS
N_BATCH_CPU = 8_192  # two runs of this size against the CPU Context
N_BATCH_FILE_RUNS = 4  # the batched files phase: 4 runs of N_INGEST

# slice 9: records ingest. The ingest route's files read through the records
# set (records -> wave_pool / wave_pool_filtered -> RecordsView). "hit" is
# requested too: no table of the event tail depends on it, and it is the
# member that reads the filtered pool on route A
RECORDS_REQUEST = ["df_paired", "hit_grouped", "waveform_width_integral", "hit"]
RECORDS_ROUTES = {
    # the defaults: hit on wave_pool_filtered (SG) standalone, the rest fused
    # over wave_pool
    "A": {"wave_source": "records"},
    # the Butterworth bandpass on the pool and every member on it: one
    # fused program over wave_pool_filtered
    "B": {"wave_source": "records",
          "wave_pool_filtered": {"filter_type": "BW", "filter_order": 4,
                                 "lowcut": 0.002, "highcut": 0.1, "fs": 0.5},
          **{m: {"use_filtered": True} for m in (
              "basic_features", "hit_threshold", "waveform_width_integral", "df")}},
}
RECORDS_STANDALONE = {"A": {"hit"}, "B": set()}
RECORDS_TABLES = ("records", "basic_features", "hit", "hit_threshold",
                  "waveform_width_integral", "df", "df_events", "hit_grouped", "df_paired")
# the JAX package's default profile on write_ingest_run(..., N_INGEST_REF,
# seed=0) with each route's config: row counts; route B's records baseline
# (the raw mean, about 1000 ADC) lies far above the bandpassed pool, so no
# sample crosses a threshold there. tests/test_torch_records.py recomputes
# these with JAX
REF_RECORDS_4096 = {
    "A": {"records": 4096, "basic_features": 4096, "hit": 4096, "hit_threshold": 6218,
          "waveform_width_integral": 4096, "df": 4096, "df_events": 2048,
          "hit_grouped": 2302, "df_paired": 2048},
    "B": {"records": 4096, "basic_features": 4096, "hit": 0, "hit_threshold": 0,
          "waveform_width_integral": 4096, "df": 4096, "df_events": 2048,
          "hit_grouped": 0, "df_paired": 2048},
}
RECORDS_PART_SIZE = 32_768  # a partitioned build of the route's files
N_V1725 = 262_144  # records (two channels per event) of WAVE_LEN samples
V1725_FILES = 4
V1725_DT_TICKS = 2_500  # between events (4 ns ticks)
# the sort and padded-gather primitives' sizes, host against device
N_PRIMITIVES = (262_144, 1_048_576)

# slice 11: chunked streaming over the ingest route's files under
# get_profile("streaming"). The four static names with derived device hooks
# stream through executor_type="device" at the default chunk_size (50,000:
# 6 chunks of 262,144); hit and hit_threshold with a left halo of one
# wave (WAVE_LEN x dt), the hits' time partition. signal_peaks_stream runs
# at its own default chunk of 4,096 (64 chunks)
STREAM_NAMES = ("basic_features", "hit", "hit_threshold", "waveform_width_integral")
STREAM_KERNEL = {"hit": "peaks_scan", "hit_threshold": "hits_scan",
                 "signal_peaks_stream": "peaks_scan"}
STREAM_CHUNK = 50_000  # StreamingConfig's default chunk_size
STREAM_WARM_RUNS = 1  # after the cold run of each stream (cut from 2 for the script's time)
STREAM_CPU_CHUNK = 4_096  # the N_INGEST_CPU run against the CPU Context: 4 chunks
SIGNAL_PEAKS_CHUNK = 4_096  # signal_peaks_stream's default chunk


_T0 = time.perf_counter()


def stamp(phase: str) -> None:
    """The seconds since the script started, after a phase (the script's
    time budget is read from these lines)."""
    print(f"elapsed after {phase}: {time.perf_counter() - _T0:.1f} s", flush=True)


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


def compare_tables(ref, out, tag: str) -> tuple:
    """Two Tables field by field (ints exact, f32 within tolerance).
    Returns (largest f32 |diff|, "tag.field" where it is)."""
    check(ref.field_names == out.field_names,
          f"{tag}: fields {out.field_names} != {ref.field_names}")
    return max((compare({f: torch.from_numpy(np.asarray(ref[f]))},
                        {f: torch.from_numpy(np.asarray(out[f]))}, tag), f"{tag}.{f}")
               for f in ref.field_names)


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


def timeit_s(fn) -> float:
    """Host wall seconds of one call of fn."""
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def kernel_tag(mangled: str) -> str:
    """A short name for a kernel's mangled symbol: its template arguments
    (``ILb1ELb0E`` -> ``<1,0>``, ``IsLb1E`` -> ``<s,1>``), else its tail."""
    m = re.search(r"kernelI(.*?)EEv", mangled)
    if not m:
        return mangled[-40:]
    return "<" + ",".join(a or b for a, b in re.findall(r"L[bi](\d+)E|([a-z])", m.group(1))) + ">"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, n_ops: float) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    float32 operations over the f32 peak."""
    return bound_at(n_bytes, n_ops, F32_OPS_PER_S)


def bound_at(n_bytes: float, n_ops: float, ops_per_s: float) -> tuple:
    """bound() with the operations at ``ops_per_s``."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def sosfiltfilt_ops(L: int, padlen: int, S: int) -> float:
    """K5's float32 operations per event: 9 per section and sample over the
    L + 2 padlen samples forward and the L + padlen backward (the backward
    cascade stops at the first central sample), the mean removal and the DC
    addition (2 L) and the odd reflection (2 per reflected sample)."""
    return (2 * L + 3 * padlen) * S * 9.0 + 2 * L + 4 * padlen


def check_chain_counts(out: dict, dev, n: int, tag: str) -> str:
    """A chain step's outputs on the device, of shape (n,), finite, with
    bench.py's JAX counts (S1 on even, S2 on odd events, overflows)."""
    for k, v in out.items():
        check(v.device == dev, f"{tag}/{k} left the device")
        if v.dim():
            check(tuple(v.shape) == (n,), f"{tag}/{k}: shape {tuple(v.shape)}")
        if v.dtype.is_floating_point:
            check(bool(torch.isfinite(v).all()), f"{tag}/{k}: non-finite values")
    label = out["label"].cpu().numpy()
    got = (int(np.sum(label[0::2] == 1)), int(np.sum(label[1::2] == 2)),
           int(out["n_peak_overflow"]), int(out["n_hit_overflow"]))
    ref = (REF_S1_EVEN, REF_S2_ODD, REF_PEAK_OVERFLOW, REF_HIT_OVERFLOW)
    check(got == ref, f"{tag} counts (S1 even, S2 odd, peak ovf, hit ovf) = {got}, "
          f"JAX reference {ref}")
    return (f"S1 {got[0]}/{n // 2} even, S2 {got[1]}/{n // 2} odd, peak overflow {got[2]}, "
            f"hit overflow {got[3]}")


def write_ingest_run(data_root: str, run: str, n: int, seed: int) -> np.ndarray:
    """A VX2730 run of ``n`` waveforms: 2 channels x INGEST_FILES files.
    The waves are bench.make_batch's (positive pulses on a 1000 ADC
    baseline, as in the earlier phases): a narrow S1 pulse on even rows, a
    wide S2 on odd rows. Channel c's row i is at i * INGEST_DT_PS + c *
    INGEST_OFFSET_PS. Returns the (n, WAVE_LEN) waves in st_waveforms' row
    order (channel 0's files, then channel 1's)."""
    from bench import make_batch
    from waveformanalysis_tpu_torch.testing.fixtures import write_vx2730_run

    waves = make_batch(n, WAVE_LEN, seed=seed)
    half = n // 2
    ts = np.arange(half, dtype=np.int64) * INGEST_DT_PS
    for ch in (0, 1):
        write_vx2730_run(data_root, run, waves[ch * half:(ch + 1) * half],
                         ts + ch * INGEST_OFFSET_PS, ch, n_files=INGEST_FILES)
    return waves


def ingest_context(ctx_cls, profile, data_root: str, storage_dir: str, device=None):
    """A Context over the DAQ files at ``data_root`` with the plugins of
    ``profile``, positive pulses on every channel (channel metadata) and
    route A's hit and S1/S2 settings (config 7's); ``device`` None for the
    JAX package's Context."""
    config = {"data_root": data_root, "daq_adapter": "vx2730", "n_channels": 2,
              "show_progress": False,
              "channel_metadata": {"defaults": {"polarity": "positive"}}}
    if device is not None:
        config["device"] = device
    ctx = ctx_cls(storage_dir=storage_dir, config=config)
    ctx.register(*profile)
    ctx.set_config(FILTER_ROUTES["A"][0])
    return ctx


def ingest_counts(ctx, run: str) -> dict:
    """Row counts of INGEST_TABLES and the S1/S2 counts of a computed run."""
    got = {m: len(ctx.get_data(run, m)) for m in INGEST_TABLES}
    lab = np.asarray(ctx.get_data(run, "s1_s2")["label"])
    got.update(n_s1=int(np.sum(lab == 1)), n_s2=int(np.sum(lab == 2)))
    return got


# the ingest route's tables held against the port's CPU Context: everything
# the request computes (filtered_waveforms without its waves, held apart)
INGEST_COMPARED = ("st_waveforms", "filtered_waveforms", "basic_features", "hit",
                   "hit_threshold", "waveform_width", "s1_s2", "hit_merged",
                   "hit_merged_components", "df", "df_events", "hit_grouped", "df_paired")


def compare_frames(ref, out, tag: str) -> float:
    """Two DataFrames column by column with their dtypes: per-event array
    cells one by one, float columns within ATOL/RTOL (NaN where NaN), the
    rest exact. Returns the largest float |diff|."""
    import pandas as pd

    check(list(out.columns) == list(ref.columns), f"{tag}: columns {list(out.columns)}")
    check(list(out.dtypes) == list(ref.dtypes) and len(out) == len(ref),
          f"{tag}: dtypes {list(out.dtypes)} != {list(ref.dtypes)} or {len(out)} != {len(ref)}")
    worst = 0.0
    for col in ref.columns:
        a, b = ref[col], out[col]
        if a.dtype == object:  # per-event array cells: lengths, dtypes, values
            cells = [[np.asarray(c) for c in side] for side in (a, b)]
            check([len(c) for c in cells[0]] == [len(c) for c in cells[1]]
                  and {c.dtype for c in cells[0]} == {c.dtype for c in cells[1]},
                  f"{tag}.{col}: cell lengths or dtypes differ")
            if not cells[0]:
                continue
            x, y = (np.concatenate(c) for c in cells)
            if np.issubdtype(x.dtype, np.floating):
                check(bool(np.allclose(y, x, atol=ATOL, rtol=RTOL)), f"{tag}.{col}: cells differ")
                if x.size:
                    worst = max(worst, float(np.max(np.abs(y.astype(np.float64) - x))))
            else:
                check(np.array_equal(x, y), f"{tag}.{col}: cells differ")
        elif np.issubdtype(a.dtype, np.floating):
            pd.testing.assert_series_equal(b, a, check_exact=False, atol=ATOL, rtol=RTOL)
            d = np.abs(b.to_numpy(np.float64) - a.to_numpy(np.float64))
            if np.isfinite(d).any():
                worst = max(worst, float(np.nanmax(d)))
        else:
            pd.testing.assert_series_equal(b, a, check_exact=True)
    return worst


def compare_ingest(cpu_ctx, gpu_ctx, run: str, names=INGEST_COMPARED, bw: bool = False) -> tuple:
    """Every table of ``names`` in ``run``, the card's against the CPU
    Context's: Table fields with their dtypes, integers exactly, floats
    within ATOL/RTOL and NaN where NaN (the filtered waves and pools within
    SG_RTOL, or BW_WAVE_ATOL with ``bw``); DataFrames column by column;
    arrays (the pools) with their dtypes. Returns the largest float |diff|
    and where it is."""
    import pandas as pd

    worst = (0.0, "")
    for name in names:
        ref, out = cpu_ctx.get_data(run, name), gpu_ctx.get_data(run, name)
        if isinstance(ref, pd.DataFrame):
            worst = max(worst, (compare_frames(ref, out, f"ingest {name}"), name))
            continue
        if isinstance(ref, np.ndarray):
            check(isinstance(out, np.ndarray) and out.dtype == ref.dtype
                  and out.shape == ref.shape, f"{name}: {type(out).__name__}")
            if np.issubdtype(ref.dtype, np.floating):
                err = float(np.max(np.abs(out.astype(np.float64) - ref), initial=0.0))
                ok = err <= BW_WAVE_ATOL if bw else bool(
                    np.isclose(out, ref, rtol=SG_RTOL, atol=0).all())
                check(ok, f"{name}: the card's pool differs from the CPU's by {err:.3g}")
            else:
                check(np.array_equal(out, ref), f"{name}: the card's pool != the CPU's")
            continue
        check(ref.field_names == out.field_names and len(ref) == len(out),
              f"ingest {name}: fields {out.field_names} x {len(out)}")
        for f in ref.field_names:
            a, b = np.asarray(ref[f]), np.asarray(out[f])
            tag = f"ingest {name}.{f}"
            check(a.dtype == b.dtype and a.shape == b.shape, f"{tag}: {b.dtype}{b.shape}")
            if not np.issubdtype(a.dtype, np.floating):
                check(np.array_equal(a, b), f"{tag}: integer mismatches")
                continue
            rtol, atol = (RTOL, ATOL)
            if (name, f) == ("filtered_waveforms", "wave"):
                rtol, atol = (0.0, BW_WAVE_ATOL) if bw else (SG_RTOL, 0.0)
            check(bool(np.isclose(b, a, rtol=rtol, atol=atol, equal_nan=True).all()),
                  f"{tag}: values outside atol {atol} / rtol {rtol}")
            d = np.abs(b.astype(np.float64) - a)
            if f != "wave" and np.isfinite(d).any():
                worst = max(worst, (float(np.nanmax(d)), f"{name}.{f}"))
    return worst


def grouping_df(n: int, seed: int):
    """A df table of ``n`` rows for the grouping phase: 4 channels, gaps
    drawn so that a fifth of the rows tie with the one before, most
    clusters hold 1 to 4 rows and long gaps leave empty windows between
    them; float32 area and height, as the plugin's df carries them."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    u = rng.random(n)
    gaps = np.where(u < 0.2, 0, np.where(u < 0.7, rng.integers(1, 60_000, n),
                                         rng.integers(150_000, 5_000_000, n)))
    ts = 10**15 + np.cumsum(gaps.astype(np.int64))
    return pd.DataFrame({
        "timestamp": rng.permutation(ts),
        "channel": rng.integers(0, 4, n).astype(np.int16),
        "area": rng.uniform(0, 100, n).astype(np.float32),
        "height": rng.uniform(0, 10, n).astype(np.float32),
    })


def make_route_context(ctx_cls, plugins, storage_dir: str, device: str,
                       config=ROUTE_CONFIG):
    ctx = ctx_cls(storage_dir=storage_dir,
                  config={"show_progress": False, "device": device})
    ctx.register(*(p() for p in plugins))
    ctx.set_config(config)
    return ctx


def filter_equal(ref: torch.Tensor, out: torch.Tensor, tag: str) -> float:
    """A filter kernel's output against its plain version's: the same dtype
    and shape, finite, bit-equal. Returns the largest |out - ref| (0.0)."""
    check(out.dtype == ref.dtype == torch.float32 and out.shape == ref.shape,
          f"{tag}: {out.dtype}{tuple(out.shape)} != {ref.dtype}{tuple(ref.shape)}")
    check(bool(torch.isfinite(out).all()), f"{tag}: non-finite values")
    err = float((out.double() - ref.double()).abs().max())
    check(torch.equal(out, ref), f"{tag}: not bit-equal (max |diff| {err:.3g})")
    return err


def standalone_members(ctx) -> set:
    return {m for m in MEMBERS if f"plugin.{m}.compute" in ctx.profiler.stats()}


def route_phases(ctx) -> dict:
    """The fused executor's and the filter plugin's profiler phases, ms."""
    keep = ("fusion.single.", "filtered_waveforms.", "plugin.", "context.")
    return {k: round(v["total_s"] * 1e3, 1) for k, v in ctx.profiler.stats().items()
            if k.startswith(keep)}


def profile_route(ctx, rid: str, tag: str, smi: str,
                  request=("s1_s2", "hit_threshold")) -> set:
    """One warm run of ``request`` under torch.profiler: device busy time,
    idle share and the largest device items (not in the medians). Returns
    the names of the port's kernels on the device timeline."""
    return profile_call(ctx, lambda: ctx.get_data(rid, list(request)), tag, smi)


def profile_call(ctx, call, tag: str, smi: str) -> set:
    """``call()`` under torch.profiler (see profile_route)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ctx.flush_saves()
    # device-side events only (kernels, copies, sets): the aten ops above
    # them repeat their time
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    dev_ms = sum(r[0] for r in rows)
    ours = [(round(t, 3), c, re.search(r"\w+_kernel", k).group(0)) for t, c, k in rows
            if "at::" not in k and re.search(r"\w+_kernel", k)]
    print(f"route profile {tag} ({smi}): wall {wall_ms:.1f} ms under the "
          f"profiler, device busy {dev_ms:.2f} ms, idle share "
          f"{1 - dev_ms / wall_ms:.3f}; top device ops (ms, calls): "
          f"{[(round(t, 3), c, k[:48]) for t, c, k in rows[:12]]}; the port's kernels "
          f"{ours}", flush=True)
    return {k for _, _, k in ours}


# the device operations that may lie between a channel group's row gather
# and its scatter in route B: the int16 -> float32 cast, the conditioning's
# reduction and elementwise ops on contiguous operands, and K5. A transposing
# copy would show as a strided ``elementwise_kernel``, a transpose or permute
# kernel, or a device-to-device copy.
K5_NEIGHBOURS = re.compile(r"(unrolled_elementwise_kernel|vectorized_elementwise_kernel|"
                           r"reduce_kernel|sosfiltfilt_kernel)<")


def route_plugin_classes() -> tuple:
    """The five S1/S2-cone plugins and FilteredWaveformsPlugin."""
    from waveformanalysis_tpu_torch.plugins.builtin.basic_features import BasicFeaturesPlugin
    from waveformanalysis_tpu_torch.plugins.builtin.filtering import FilteredWaveformsPlugin
    from waveformanalysis_tpu_torch.plugins.builtin.hit_finder import ThresholdHitPlugin
    from waveformanalysis_tpu_torch.plugins.builtin.peak_finding import HitFinderPlugin
    from waveformanalysis_tpu_torch.plugins.builtin.s1_s2_classifier import S1S2ClassifierPlugin
    from waveformanalysis_tpu_torch.plugins.builtin.waveform_width import WaveformWidthPlugin

    return (BasicFeaturesPlugin, HitFinderPlugin, ThresholdHitPlugin, WaveformWidthPlugin,
            S1S2ClassifierPlugin, FilteredWaveformsPlugin)


def trace_route_b() -> None:
    """``--trace-route-b``: one warm route-B run of N_EVENTS events under
    torch.profiler, as the process's first profiler session. Fails unless
    the device timeline holds every K5 launch the wrapper counted (one per
    hardware channel) and, between each channel group's row gather and its
    scatter, only K5_NEIGHBOURS: no transposing copy around K5."""
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this trace needs a GPU")
    sys.path.insert(0, str(ROOT))
    from bench import make_batch
    from waveformanalysis_tpu_torch.context.context import Context
    from waveformanalysis_tpu_torch.ops import filter_cuda as flc
    from waveformanalysis_tpu_torch.testing.fixtures import st_waveforms_from_waves

    cfg, bl = FILTER_ROUTES["B"]
    with tempfile.TemporaryDirectory() as tmp:
        ctx = make_route_context(Context, route_plugin_classes(), tmp, "cuda", cfg)
        for rid, seed in (("warm", 398), ("traced", 399)):
            ctx.inject_data(rid, "st_waveforms", st_waveforms_from_waves(
                make_batch(N_EVENTS, WAVE_LEN, seed=seed), baseline=bl))
        ctx.get_data("warm", ["s1_s2", "hit_threshold"])
        torch.cuda.synchronize()
        before = flc.sosfiltfilt_cuda.launches
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ctx.get_data("traced", ["s1_s2", "hit_threshold"])
            torch.cuda.synchronize()
        launched = flc.sosfiltfilt_cuda.launches - before
        ctx.flush_saves()
    timeline = sorted((e.start_ns(), e.name()) for e in prof.profiler.kineto_results.events()
                      if str(e.device_type()).endswith("CUDA"))
    names = [re.sub(r"^void |\(anonymous namespace\)::|at::native::", "", name)
             for _, name in timeline]
    k5 = [i for i, name in enumerate(names) if name.startswith("sosfiltfilt_kernel")]
    check(launched == 2 and len(k5) == launched, f"route B trace: {launched} K5 launches "
          f"counted, {len(k5)} on the device timeline (expected 2 and 2)")
    windows = []
    for i in k5:
        gathers = [j for j in range(i) if "gather" in names[j]]
        scatters = [j for j in range(i + 1, len(names))
                    if names[j].startswith("index_elementwise_kernel")]
        check(bool(gathers and scatters), f"route B trace: no gather / scatter around the K5 "
              f"launch at {i}: {[nm[:40] for nm in names[max(i - 6, 0):i + 3]]}")
        g, sc = gathers[-1], scatters[0]
        others = [nm[:60] for nm in names[g + 1:sc] if not K5_NEIGHBOURS.match(nm)]
        check(not others, f"route B trace: between a group's gather and its scatter around "
              f"K5: {others}")
        windows.append([nm[:36] for nm in names[g:sc + 1]])
    print(f"route B trace {N_EVENTS}x{WAVE_LEN}: {len(k5)} K5 launches on the device timeline, "
          f"{launched} counted; each channel group's gather .. scatter: {windows}; nothing "
          f"else between them (no transposing copy)", flush=True)


def step_ops(fn) -> dict:
    """One call of fn under torch.profiler: its device operations (name ->
    (calls, ms)) and the aten operations it dispatched (name -> calls)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_ops, aten = {}, {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            if e.self_device_time_total > 0:
                dev_ops[e.key[:60]] = (e.count, round(e.self_device_time_total / 1e3, 3))
        elif e.key.startswith("aten::"):
            aten[e.key] = e.count
    return {"device": dev_ops, "aten": aten}


def on_card(dev) -> bool:
    return dev.type == "cuda"


def nonzero(got: dict) -> dict:
    """The launch counts that are not 0."""
    return {k: v for k, v in got.items() if v}


def ingest_phase(dev, smi: str, kernels: dict, n: int, n_cpu: int, daq: str) -> tuple:
    """Slice 8's main path: ``get_data(run, INGEST_REQUEST)`` on VX2730
    files of ``n`` waveforms through the default profile, cold and then 3
    warm runs, each under a fresh run name: the first written (the write
    timed apart), the others linked to its files (link_run). Checks
    the native decoder, that K2 and K3 and no other kernel launched, that
    the first run's st_waveforms equals the written arrays (the baseline the
    float64 mean of its window, exactly), and that the memory allocated
    after each run stays flat. Then the card's tables of an ``n_cpu`` run
    ("cmp") against the port's CPU Context, and the row counts of an
    N_INGEST_REF run ("ref") against the JAX package's. The runs are written
    under ``daq``; the last timed run ("ingest3", a link to "ingest0"),
    "cmp" and "ref" stay there for the records phase. Returns the first
    run's launch counts and the written waves."""
    import waveformanalysis_tpu_torch as wa
    from waveformanalysis_tpu_torch import native
    from waveformanalysis_tpu_torch.context.context import Context
    from waveformanalysis_tpu_torch.plugins.plugin_sets import get_profile
    from waveformanalysis_tpu_torch.processing.records_builder import resolve_baseline_window

    # the g++ CSV decoder builds into build/native and loads: the ingest
    # path parses with it, not with a slower Python engine
    decoder = native.get_lib()
    lib_path = native.loaded_path()
    check(decoder is not None and lib_path is not None
          and lib_path.parent == ROOT / "build" / "native",
          f"the native CSV decoder did not build into build/native ({lib_path})")
    with tempfile.TemporaryDirectory() as tmp:
        ctx = ingest_context(Context, get_profile("cuda"), daq, f"{tmp}/run", dev.type)
        walls, writes, flushes, phases, held = [], [], [], [], []
        for i in range(4):  # cold, then three warm runs, each on a fresh run
            run = f"ingest{i}"
            if i:  # the same files under a fresh run name (nothing cached for it)
                link_run(daq, "ingest0", run)
            else:
                t0 = time.perf_counter()
                written = write_ingest_run(daq, run, n, seed=500)
                writes.append(time.perf_counter() - t0)
            if i == 0:  # the decoder alone on one file in this host's page cache
                one = sorted(Path(daq, run, "RAW").glob("*.CSV"))[1]
                blob = one.read_bytes()
                t_native = min(timeit_s(lambda: native.decode_csv_bytes(blob)) for _ in range(3))
                reader = wa.get_adapter("vx2730").format_reader
                t_arrow = timeit_s(lambda: reader.read_file(one, is_first_file=False,
                                                            parse_engine="pyarrow"))
                csv_bytes = sum(f.stat().st_size for f in Path(daq, run, "RAW").iterdir())
            ctx.profiler.reset()
            for fn in kernels.values():
                fn.launches = 0
            t0 = time.perf_counter()
            res = ctx.get_data(run, INGEST_REQUEST)
            if on_card(dev):
                torch.cuda.synchronize(dev)
            walls.append(time.perf_counter() - t0)
            got = {name: fn.launches for name, fn in kernels.items()}
            if on_card(dev):
                check(got["peaks_scan"] >= 1 and got["hits_scan"] >= 1 and all(
                    v == 0 for k, v in got.items() if k not in ("peaks_scan", "hits_scan")),
                    f"ingest route {run}: launches {got}, expected K2 and K3 only")
            phases.append({k: v["total_s"] for k, v in ctx.profiler.stats().items()})
            check(list(res) == INGEST_REQUEST and len(res["df_paired"]) > 0
                  and len(res["hit_grouped"]) > 0 and len(res["s1_s2"]) > 0,
                  f"ingest route {run}: empty results")
            if i == 0:
                first_launches = got
                check_ingested(ctx.get_data(run, "st_waveforms"), written, n,
                               wa.get_adapter("vx2730").format_spec.columns,
                               resolve_baseline_window)
                lab = np.asarray(res["s1_s2"]["label"])
                sizes = {m: len(ctx.get_data(run, m)) for m in INGEST_TABLES}
                print(f"main path 8 ingest {n}x{WAVE_LEN} (2 channels x {INGEST_FILES} files, "
                      f"{csv_bytes} bytes of CSV): get_data({INGEST_REQUEST}) launches {got}; "
                      f"tables {sizes}, S1 {int(np.sum(lab == 1))}, S2 {int(np.sum(lab == 2))}; "
                      f"st_waveforms wave/timestamp/board/channel/event_length = the written "
                      f"arrays, baseline = the float64 mean of its window exactly; native "
                      f"decoder {lib_path.relative_to(ROOT)}: {len(blob)} bytes in "
                      f"{t_native * 1e3:.1f} ms = {len(blob) / t_native / 1e6:.0f} MB/s "
                      f"(pyarrow engine {t_arrow * 1e3:.1f} ms) on this host", flush=True)
            del res
            t0 = time.perf_counter()
            ctx.flush_saves()
            flushes.append(time.perf_counter() - t0)
            held.append(torch.cuda.memory_allocated(dev) if on_card(dev) else 0)
            if 0 < i < 3:
                Path(daq, run).unlink()
        keys = ("plugin.raw_files.compute", "st_waveforms.decode", "st_waveforms.structure",
                "plugin.st_waveforms.compute", "plugin.filtered_waveforms.compute",
                "fusion.single.load", "fusion.single.upload", "fusion.single.device_program",
                "fusion.single.fetch", "fusion.single.finalize", "plugin.hit.compute",
                "plugin.waveform_width.compute", "plugin.s1_s2.compute", "plugin.df.compute",
                "plugin.df_events.compute", "plugin.hit_grouped.compute",
                "plugin.df_paired.compute", "context.save_cache",
                "context.release_device_columns")
        med = statistics.median(walls[1:])
        med_ph = {k: round(statistics.median(p.get(k, 0.0) for p in phases[1:]) * 1e3, 1)
                  for k in keys}
        check(max(held) - min(held) <= 16 << 20, f"ingest route: memory allocated after each "
              f"run {held} B is not flat")
        print(f"route ingest {n}x{WAVE_LEN} ({smi}): write {writes[0]:.2f} s (numpy, apart from "
              f"the route; the warm runs read the same files under fresh names); cold {walls[0]:.3f} s; warm median of 3 "
              f"{med * 1e3:.1f} ms = {n / med:.0f} waveforms/s (runs "
              f"{[round(x * 1e3, 1) for x in walls[1:]]} ms); phases ms {med_ph}; flush_saves "
              f"median {statistics.median(flushes[1:]) * 1e3:.1f} ms; memory allocated after "
              f"each run {held} B", flush=True)
        del ctx

        # the card's tables against the port's CPU Context, and the row
        # counts against the JAX package's
        write_ingest_run(daq, "cmp", n_cpu, seed=7)
        gpu = ingest_context(Context, get_profile("cuda"), daq, f"{tmp}/cmp_dev", dev.type)
        gpu.get_data("cmp", INGEST_REQUEST)
        t_cpu = time.perf_counter()
        cpu = ingest_context(Context, get_profile("cuda"), daq, f"{tmp}/cmp_cpu", "cpu")
        cpu.get_data("cmp", INGEST_REQUEST)
        t_cpu = time.perf_counter() - t_cpu
        err, where = compare_ingest(cpu, gpu, "cmp")
        print(f"main path 8 at {n_cpu}x{WAVE_LEN}: every table of the request "
              f"{list(INGEST_COMPARED)} = the CPU Context's (DataFrames column by column with "
              f"their dtypes; max |f32 diff| {err:.3g}, {where}; CPU route {t_cpu:.1f} s); "
              f"counts {ingest_counts(gpu, 'cmp')}", flush=True)
        for c in (gpu, cpu):
            c.flush_saves()
        write_ingest_run(daq, "ref", N_INGEST_REF, seed=0)
        ctx = ingest_context(Context, get_profile("cuda"), daq, f"{tmp}/ref", dev.type)
        ctx.get_data("ref", INGEST_REQUEST)
        got = ingest_counts(ctx, "ref")
        ctx.flush_saves()
        check(got == REF_INGEST_4096, f"ingest at {N_INGEST_REF}: {got}, JAX reference "
              f"{REF_INGEST_4096}")
        print(f"main path 8 at {N_INGEST_REF}x{WAVE_LEN}: {got} (= JAX reference)", flush=True)
    return first_launches, written


def check_ingested(st, written: np.ndarray, n: int, columns, resolve_baseline_window) -> None:
    """st_waveforms of a write_ingest_run run against the written arrays:
    wave, timestamp, board, channel and event_length exactly, and baseline
    the float64 numpy mean over the format's baseline window, exactly (the
    JAX package's formula)."""
    half = n // 2
    check(np.array_equal(np.asarray(st["wave"]), written.astype(np.int16)),
          "ingest st_waveforms.wave != the written samples")
    ts = np.tile(np.arange(half, dtype=np.int64) * INGEST_DT_PS, 2)
    ts[half:] += INGEST_OFFSET_PS
    for f, want in (("timestamp", ts), ("board", np.zeros(n, np.int16)),
                    ("channel", np.repeat(np.arange(2, dtype=np.int16), half)),
                    ("event_length", np.full(n, WAVE_LEN, np.int32))):
        col = np.asarray(st[f])
        check(col.dtype == want.dtype and np.array_equal(col, want),
              f"ingest st_waveforms.{f} != the written {f}")
    lo, hi = resolve_baseline_window(None, columns.samples_start, columns.baseline_start,
                                     columns.baseline_end)
    first = columns.samples_start
    want = np.mean(written[:, lo - first:hi - first].astype(np.float64), axis=1)
    check(np.array_equal(np.asarray(st["baseline"]), want),
          "ingest st_waveforms.baseline != the float64 mean of the baseline window")


def grouping_phase(dev, smi: str, sizes) -> None:
    """df_events (group_multi_channel_hits), events (group_events_columnar)
    and df_paired (pair_events) with backend "device" (torch ops on ``dev``)
    against "host" (numpy) on grouping_df tables of each size: equal
    outputs; wall times in turns host, device, device, host after a warm-up
    on a small table."""
    from waveformanalysis_tpu_torch.ops import grouping as G

    warm = grouping_df(4096, seed=1)
    G.pair_events(G.group_multi_channel_hits(warm, 100.0, backend="device", device=dev),
                  100.0, 2, backend="device", device=dev)
    for n_rows in sizes:
        df = grouping_df(n_rows, seed=n_rows % 1000)
        out, t = {}, {"host": [], "device": []}
        for backend in ("host", "device", "device", "host"):
            t0 = time.perf_counter()
            ev = G.group_multi_channel_hits(df, 100.0, backend=backend, device=dev)
            t1 = time.perf_counter()
            cols = G.group_events_columnar(df, 100.0, backend=backend, device=dev)
            t2 = time.perf_counter()
            paired = G.pair_events(ev, 100.0, 2, start_channel=6, backend=backend, device=dev)
            t3 = time.perf_counter()
            t[backend].append((t1 - t0, t2 - t1, t3 - t2))
            out[backend] = (ev, cols, paired)
        (ev_h, cols_h, pa_h), (ev_d, cols_d, pa_d) = out["host"], out["device"]
        compare_frames(ev_h, ev_d, f"df_events device {n_rows}")
        compare_frames(pa_h, pa_d, f"df_paired device {n_rows}")
        for k in cols_h:
            check(cols_h[k].dtype == cols_d[k].dtype and np.array_equal(cols_h[k], cols_d[k]),
                  f"events device {n_rows}: {k} differs from the host's")
        ms = {b: [round(statistics.mean(x[j] for x in t[b]) * 1e3, 1) for j in range(3)]
              for b in t}
        print(f"grouping {n_rows} df rows ({smi}): {len(ev_h)} events, {len(pa_h)} paired "
              f"({int(pa_h['area_ch7'].isna().sum())} without a second hit); device = host on "
              f"df_events, events and df_paired; ms (df_events, events, df_paired), mean of 2 "
              f"in turns: host {ms['host']}, device {ms['device']}", flush=True)


def tutorial_phase() -> None:
    """The port's tutorial, as a user runs it (on the card by default)."""
    proc = subprocess.run([sys.executable, "-m", "waveformanalysis_tpu_torch.examples.tutorial"],
                          capture_output=True, text=True, timeout=600, cwd=ROOT)
    check(proc.returncode == 0, f"the tutorial failed: {proc.stderr.strip()[-3000:]}")
    paired = [ln for ln in proc.stdout.splitlines() if ln.startswith("df_paired:")]
    check("device: cuda" in proc.stdout and bool(paired), "the tutorial did not run on the card")
    print(f"tutorial (python -m waveformanalysis_tpu_torch.examples.tutorial): exit 0 on the "
          f"card; {paired[0][:60]}", flush=True)


def records_context(ctx_cls, profile, data_root: str, storage_dir: str, route: str,
                    device=None, adapter: str = "vx2730"):
    """ingest_context's Context with RECORDS_ROUTES[route] set (and the DAQ
    adapter ``adapter``)."""
    ctx = ingest_context(ctx_cls, profile, data_root, storage_dir, device)
    if adapter != "vx2730":
        ctx.set_config({"daq_adapter": adapter})
    ctx.set_config(RECORDS_ROUTES[route])
    return ctx


def records_counts(ctx, run: str) -> dict:
    return {m: len(ctx.get_data(run, m)) for m in RECORDS_TABLES}


def link_run(daq: str, source: str, run: str) -> str:
    """A fresh run name whose directory is ``source``'s (a symlink)."""
    Path(daq, run).symlink_to(Path(daq, source), target_is_directory=True)
    return run


def records_standalone(ctx) -> set:
    return {m for m in ("basic_features", "hit", "hit_threshold", "waveform_width_integral")
            if f"plugin.{m}.compute" in ctx.profiler.stats()}


def check_records_launches(route: str, got: dict, n_groups: int, tag: str) -> None:
    """Route A: K2 (the standalone hit) and K3 (the fused hit_threshold);
    route B: K5 once per channel group, then K2 and K3 in the fused
    program; no other kernel."""
    want = {"sosfiltfilt": n_groups if route == "B" else 0}
    check(got["peaks_scan"] >= 1 and got["hits_scan"] >= 1 and all(
        got[k] == want.get(k, 0) for k in got if k not in ("peaks_scan", "hits_scan")),
        f"{tag}: launches {got}, expected K2 and K3{' and K5 x%d' % n_groups if want['sosfiltfilt'] else ''} only")


def plain_filtered_pool(ctx, run: str, dev) -> tuple:
    """wave_pool_filtered of ``run`` recomputed on ``dev`` with the plain
    zero-phase filter (sosfiltfilt_plain) on each channel group's rows of
    the pool, as the plugin gathers them; with the group count."""
    from waveformanalysis_tpu_torch.hardware import group_indices_by_hardware_channel
    from waveformanalysis_tpu_torch.ops import filtering as flt

    rec, pool = ctx.get_data(run, "records"), ctx.get_data(run, "wave_pool")
    bw = RECORDS_ROUTES["B"]["wave_pool_filtered"]
    sos = flt.design_butterworth_sos(bw["filter_order"], bw["lowcut"], bw["highcut"], bw["fs"])
    out = torch.zeros(len(pool), dtype=torch.float32, device=dev)
    pool_d = torch.from_numpy(pool.view(np.int16)).to(dev)
    offsets, lengths = np.asarray(rec["wave_offset"]), np.asarray(rec["event_length"])
    groups = group_indices_by_hardware_channel(rec["board"], rec["channel"])
    for idx in groups.values():
        check(bool(np.all(lengths[idx] == WAVE_LEN)), "records: a record of another length")
        rows = torch.from_numpy(offsets[idx] // WAVE_LEN).to(dev)
        waves = (pool_d.view(-1, WAVE_LEN)[rows].to(torch.int32) & 0xFFFF).to(torch.float32)
        out.view(-1, WAVE_LEN)[rows] = flt.sosfiltfilt_plain(waves, sos)
    return out.cpu().numpy(), len(groups)


# the records phases' profiler phases, in the order the request runs them
RECORDS_PHASES = (
    "plugin.raw_files.compute", "records.build", "records.decode", "records.concat",
    "records.sort", "records.gather", "records.polarity", "plugin.wave_pool_filtered.compute",
    "wave_pool_filtered.upload", "wave_pool_filtered.gather", "wave_pool_filtered.filter",
    "wave_pool_filtered.scatter", "wave_pool_filtered.fetch", "plugin.hit.compute",
    "fusion.single.load", "fusion.single.upload", "fusion.single.device_program",
    "fusion.single.fetch", "fusion.single.finalize", "plugin.df.compute",
    "plugin.df_events.compute", "plugin.hit_grouped.compute", "plugin.df_paired.compute",
    "context.release_device_columns")
RECORDS_COMPARED = ("records", "wave_pool", "wave_pool_filtered", "basic_features", "hit",
                    "hit_threshold", "waveform_width_integral", "hit_merged",
                    "hit_merged_components", "df", "df_events", "hit_grouped", "df_paired")


def records_phase(dev, smi: str, kernels: dict, daq: str, written: np.ndarray, n: int,
                  n_cpu: int) -> dict:
    """Slice 9's main path: ``get_data(run, RECORDS_REQUEST)`` through the
    records set on the ingest phase's files of ``n`` waveforms ("ingest3",
    ``written``), each run a fresh name linked to them; routes A and B, cold
    and then 3 warm runs each. Checks the launches, the plan (route A: hit
    alone, route B: every member fused), the first run's pool against the
    written samples in time order, route B's pool from K5 against the plain
    filter on the card bit for bit, and the memory allocated after each run,
    flat; profiles a warm route-A run (device busy time and idle share, K2
    and K3 on the timeline). Then a build with RECORDS_PART_SIZE parts
    against the one-part bundle, the card's tables of the ingest phase's
    ``n_cpu`` run ("cmp") against the port's CPU Context and the counts of
    its N_INGEST_REF run ("ref") against the JAX package's, on both routes.
    Returns the first run's launch counts of each route."""
    from waveformanalysis_tpu_torch.context.context import Context
    from waveformanalysis_tpu_torch.plugins.plugin_sets import get_profile

    # records are in time order: channel 0's row i, then channel 1's row i
    half = n // 2
    in_time = np.empty_like(written)
    in_time[0::2], in_time[1::2] = written[:half], written[half:]
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        for route in ("A", "B"):
            ctx = records_context(Context, get_profile("cuda"), daq, f"{tmp}/{route}", route,
                                  dev.type)
            walls, phases, held = [], [], []
            for i in range(4):
                run = link_run(daq, "ingest3", f"rec{route}{i}")
                ctx.profiler.reset()
                for fn in kernels.values():
                    fn.launches = 0
                t0 = time.perf_counter()
                res = ctx.get_data(run, RECORDS_REQUEST)
                if on_card(dev):
                    torch.cuda.synchronize(dev)
                walls.append(time.perf_counter() - t0)
                got = {name: fn.launches for name, fn in kernels.items()}
                stats = ctx.profiler.stats()
                phases.append({k: v["total_s"] for k, v in stats.items()})
                if on_card(dev):
                    check_records_launches(route, got, 2, f"records route {route} {run}")
                standalone = records_standalone(ctx)
                check(standalone == RECORDS_STANDALONE[route]
                      and "fusion.wave_chain.compute" in stats,
                      f"records route {route}: standalone {standalone}, expected "
                      f"{RECORDS_STANDALONE[route]} beside one fused program")
                check(list(res) == RECORDS_REQUEST and len(res["df_paired"]) > 0
                      and len(res["waveform_width_integral"]) == n,
                      f"records route {route} {run}: results {[len(v) for v in res.values()]}")
                if i == 0:
                    launches[route] = got
                    pool = ctx.get_data(run, "wave_pool")
                    check(isinstance(pool, np.ndarray) and pool.dtype == np.uint16
                          and np.array_equal(pool.view(np.int16).reshape(n, WAVE_LEN), in_time),
                          f"records route {route}: wave_pool != the written samples in time order")
                    extra = ""
                    if route == "B":
                        plain, n_groups = plain_filtered_pool(ctx, run, dev)
                        filtered = ctx.get_data(run, "wave_pool_filtered")
                        check(filtered.dtype == np.float32 and np.array_equal(filtered, plain),
                              "records route B: wave_pool_filtered from K5 is not bit-equal to "
                              "the plain filter's on the card")
                        extra = (f"; wave_pool_filtered ({n_groups} channel groups through K5) "
                                 f"= the plain filter's on the card, bit for bit")
                    print(f"main path 9{route.lower()} records {n}x{WAVE_LEN}: get_data("
                          f"{RECORDS_REQUEST}) launches {got}; standalone {sorted(standalone)}, "
                          f"the rest in one fused program; tables {records_counts(ctx, run)}; "
                          f"wave_pool = the written samples in time order{extra}", flush=True)
                del res
                ctx.flush_saves()
                held.append(torch.cuda.memory_allocated(dev) if on_card(dev) else 0)
            check(max(held) - min(held) <= 16 << 20, f"records route {route}: memory allocated "
                  f"after each run {held} B is not flat")
            med = statistics.median(walls[1:])
            med_ph = {k: round(statistics.median(p.get(k, 0.0) for p in phases[1:]) * 1e3, 1)
                      for k in RECORDS_PHASES}
            print(f"route records {route} {n}x{WAVE_LEN} ({smi}): cold {walls[0]:.3f} s; warm "
                  f"median of 3 {med * 1e3:.1f} ms = {n / med:.0f} waveforms/s (runs "
                  f"{[round(x * 1e3, 1) for x in walls[1:]]} ms); phases ms {med_ph}; memory "
                  f"allocated after each run {held} B", flush=True)
            if route == "A" and on_card(dev):
                seen = profile_route(ctx, link_run(daq, "ingest3", "recAprof"),
                                     f"records A {n}x{WAVE_LEN}", smi, RECORDS_REQUEST)
                check({"peaks_warp_kernel", "hits_warp_kernel"} <= seen,
                      f"records route A profile: the device timeline shows {seen}, not K2 and K3")
                ctx.flush_saves()
            del ctx

        # a partitioned build gives the same bundle (pid, the part index, aside)
        ctx = records_context(Context, get_profile("cuda"), daq, f"{tmp}/part", "A", dev.type)
        one = ctx.get_data(link_run(daq, "ingest3", "recP1"), ["records", "wave_pool"])
        ctx.set_config({"records_part_size": RECORDS_PART_SIZE})
        parts = ctx.get_data(link_run(daq, "ingest3", "recP2"), ["records", "wave_pool"])
        for f in one["records"].field_names:
            a, b = np.asarray(one["records"][f]), np.asarray(parts["records"][f])
            check(f == "pid" or np.array_equal(a, b, equal_nan=a.dtype.kind == "f"),
                  f"records with part size {RECORDS_PART_SIZE}: {f} differs")
        check(np.array_equal(one["wave_pool"], parts["wave_pool"]),
              f"records with part size {RECORDS_PART_SIZE}: wave_pool differs")
        n_parts = len(np.unique(np.asarray(parts["records"]["pid"])))
        ctx.flush_saves()
        del ctx, one, parts
        print(f"main path 9 records {n}x{WAVE_LEN} built in parts of {RECORDS_PART_SIZE} "
              f"({n_parts} per channel): the same records (pid aside) and wave_pool as one part",
              flush=True)

        for route in ("A", "B"):
            gpu = records_context(Context, get_profile("cuda"), daq, f"{tmp}/cmp{route}d", route,
                                  dev.type)
            cpu = records_context(Context, get_profile("cuda"), daq, f"{tmp}/cmp{route}c", route,
                                  "cpu")
            run = link_run(daq, "cmp", f"rcmp{route}")
            gpu.get_data(run, RECORDS_REQUEST)
            t_cpu = time.perf_counter()
            cpu.get_data(run, RECORDS_REQUEST)
            t_cpu = time.perf_counter() - t_cpu
            err, where = compare_ingest(cpu, gpu, run, RECORDS_COMPARED, bw=route == "B")
            print(f"main path 9{route.lower()} records at {n_cpu}x{WAVE_LEN}: every table of the "
                  f"request {list(RECORDS_COMPARED)} = the CPU Context's (max |f32 diff| "
                  f"{err:.3g}, {where}; CPU route {t_cpu:.1f} s); counts "
                  f"{records_counts(gpu, run)}", flush=True)
            for c in (gpu, cpu):
                c.flush_saves()
            ctx = records_context(Context, get_profile("cuda"), daq, f"{tmp}/ref{route}", route,
                                  dev.type)
            run = link_run(daq, "ref", f"rref{route}")
            ctx.get_data(run, RECORDS_REQUEST)
            got = records_counts(ctx, run)
            ctx.flush_saves()
            check(got == REF_RECORDS_4096[route], f"records route {route} at {N_INGEST_REF}: "
                  f"{got}, JAX reference {REF_RECORDS_4096[route]}")
            print(f"main path 9{route.lower()} records at {N_INGEST_REF}x{WAVE_LEN}: {got} "
                  f"(= JAX reference)", flush=True)
    return launches


def v1725_phase(dev, smi: str, kernels: dict, n: int) -> None:
    """The records route under the V1725 adapter on ``n`` records (n / 2
    events of two channels, bench.py's waves, V1725_FILES files written by
    ``write_v1725_run``): K2 and K3 launched, the pool = the written samples
    in time order; then ``st_waveforms`` with ``device_unpack=True`` (the
    unpack on the card) against the host walk, every column bit-identical,
    both timed."""
    from bench import make_batch
    from waveformanalysis_tpu_torch.context.context import Context
    from waveformanalysis_tpu_torch.plugins.plugin_sets import get_profile
    from waveformanalysis_tpu_torch.testing.fixtures import write_v1725_run

    waves = make_batch(n, WAVE_LEN, seed=600)
    events = n // 2
    ts = np.arange(events, dtype=np.int64) * V1725_DT_TICKS
    with tempfile.TemporaryDirectory() as tmp:
        daq = f"{tmp}/DAQ"
        t_write = time.perf_counter()
        write_v1725_run(daq, "v0", n_events=events, n_samples=WAVE_LEN,
                        waves={0: waves[0::2], 1: waves[1::2]}, timestamps={0: ts, 1: ts + 5},
                        baselines={0: 1000, 1: 1000}, n_files=V1725_FILES)
        t_write = time.perf_counter() - t_write
        size = sum(f.stat().st_size for f in Path(daq, "v0", "RAW").iterdir())
        ctx = records_context(Context, get_profile("cuda"), daq, f"{tmp}/rec", "A", dev.type,
                              adapter="v1725")
        walls = []
        for i in range(2):
            run = "v0" if i == 0 else link_run(daq, "v0", "v1")
            for fn in kernels.values():
                fn.launches = 0
            t0 = time.perf_counter()
            res = ctx.get_data(run, RECORDS_REQUEST)
            if on_card(dev):
                torch.cuda.synchronize(dev)
            walls.append(time.perf_counter() - t0)
            got = {name: fn.launches for name, fn in kernels.items()}
            if on_card(dev):
                check_records_launches("A", got, 2, f"V1725 records route {run}")
            check(len(res["df_paired"]) > 0 and len(res["waveform_width_integral"]) == n,
                  f"V1725 records route {run}: results {[len(v) for v in res.values()]}")
        pool = ctx.get_data("v0", "wave_pool")
        check(np.array_equal(pool.view(np.int16).reshape(n, WAVE_LEN), waves),
              "V1725 records: wave_pool != the written samples in time order")
        counts = records_counts(ctx, "v0")
        ctx.flush_saves()
        print(f"main path 9 V1725 records {n}x{WAVE_LEN} ({smi}; {V1725_FILES} files, {size} "
              f"bytes, written in {t_write:.2f} s): launches {got}; tables {counts}; wave_pool = "
              f"the written samples in time order; cold {walls[0]:.3f} s, warm "
              f"{walls[1] * 1e3:.1f} ms = {n / walls[1]:.0f} records/s", flush=True)
        del ctx, res, pool

        tables, secs = {}, {}
        for unpack in (False, True):
            ctx = ingest_context(Context, get_profile("cuda"), daq, f"{tmp}/st{unpack}", dev.type)
            ctx.set_config({"daq_adapter": "v1725", "st_waveforms": {"device_unpack": unpack}})
            run = link_run(daq, "v0", f"st{int(unpack)}")
            t0 = time.perf_counter()
            tables[unpack] = ctx.get_data(run, "st_waveforms")
            secs[unpack] = (time.perf_counter() - t0,
                            ctx.profiler.stats()["plugin.st_waveforms.compute"]["total_s"])
            ctx.flush_saves()
        host, unpacked = tables[False], tables[True]
        check(host.field_names == unpacked.field_names and len(host) == len(unpacked) == n,
              f"V1725 st_waveforms: {unpacked.field_names} x {len(unpacked)}")
        for f in host.field_names:
            a, b = np.asarray(host[f]), unpacked[f]
            check(isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
                  and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"),
                  f"V1725 st_waveforms device_unpack: {f} differs from the host walk")
        print(f"main path 9 V1725 st_waveforms {n}x{WAVE_LEN}: device_unpack=True (the unpack on "
              f"{dev.type}) = the host walk on every column, bit for bit; get_data wall / plugin "
              f"compute: host walk {secs[False][0] * 1e3:.1f} / {secs[False][1] * 1e3:.1f} ms, "
              f"device unpack {secs[True][0] * 1e3:.1f} / {secs[True][1] * 1e3:.1f} ms "
              f"(first call of each)", flush=True)


def sort_records(n: int, boards: int, seed: int):
    """A records table's sort keys as the builder concatenates its parts:
    each (board, channel) time-sorted, 2 channels per board, a tenth of the
    timestamps shared across channels. With one board the single stable
    timestamp sort is the order (the fast path); with two, board 1's rows
    come first, so ties need the five-key fallback."""
    from waveformanalysis_tpu_torch.dtypes.table import Table

    rng = np.random.default_rng(seed)
    groups = [(b, c) for b in range(boards)[::-1] for c in range(2)]
    per = n // len(groups)
    base = np.cumsum(rng.integers(1, 20_000, per)).astype(np.int64) * 1000
    ts, board, chan = [], [], []
    for b, c in groups:
        own = np.sort(base + rng.integers(0, 5, per) * 1000 * (rng.random(per) > 0.1))
        ts.append(own)
        board.append(np.full(per, b, np.int16))
        chan.append(np.full(per, c, np.int16))
    return Table({"timestamp": np.concatenate(ts), "pid": np.zeros(per * len(groups), np.int32),
                  "board": np.concatenate(board), "channel": np.concatenate(chan)},
                 validate=False)


def primitives_phase(dev, smi: str, sizes) -> None:
    """The records primitives, host against device, at each size: the sort
    order (``records_sort_order`` against ``records_sort_order_device``) on
    the builder's part layout (the fast path) and with ties across boards
    (the five-key fallback); the padded wave matrix (``padded_wave_matrix``,
    and with its upload, against ``padded_wave_matrix_device``) on a pool of
    whole WAVE_LEN rows and on a ragged pool (lengths 192..WAVE_LEN). Equal
    outputs; wall times in turns host, device, device, host after a warm-up."""
    from waveformanalysis_tpu_torch.data.records_view import RecordsView
    from waveformanalysis_tpu_torch.dtypes.table import Table
    from waveformanalysis_tpu_torch.processing.records_builder import (
        records_sort_order,
        records_sort_order_device,
    )

    def sync():
        if on_card(dev):
            torch.cuda.synchronize(dev)

    def turns(host_fn, dev_fn):
        host_fn(), dev_fn(), sync()
        t = {"host": [], "device": []}
        out = {}
        for side in ("host", "device", "device", "host"):
            t0 = time.perf_counter()
            out[side] = (host_fn if side == "host" else dev_fn)()
            sync()
            t[side].append((time.perf_counter() - t0) * 1e3)
        return out, {k: round(statistics.mean(v), 2) for k, v in t.items()}

    records_sort_order_device(sort_records(4096, 1, 0), device=dev)
    for n in sizes:
        for boards in (1, 2):
            rec = sort_records(n, boards, seed=n % 997 + boards)
            out, ms = turns(lambda: records_sort_order(rec),
                            lambda: records_sort_order_device(rec, device=dev))
            check(np.array_equal(out["host"], out["device"]),
                  f"sort order {n} rows, {boards} board(s): device != host")
            print(f"records sort {n} rows ({boards} board(s), "
                  f"{'fast path' if boards == 1 else 'five-key fallback'}; {smi}): device = host; "
                  f"ms, mean of 2 in turns: host {ms['host']}, device {ms['device']}", flush=True)
        rng = np.random.default_rng(n)
        for ragged in (False, True):
            lengths = (rng.integers(192, WAVE_LEN + 1, n) if ragged
                       else np.full(n, WAVE_LEN)).astype(np.int32)
            offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
            pool = rng.integers(0, 1 << 16, int(lengths.sum()), dtype=np.uint16)
            rec = Table({"wave_offset": offsets, "event_length": lengths,
                         "record_id": np.arange(n, dtype=np.int64)}, validate=False)
            view = RecordsView(rec, pool)
            out, ms = turns(lambda: view.padded_wave_matrix()[0],
                            lambda: view.padded_wave_matrix_device(device=dev)[0])
            check(np.array_equal(out["host"], out["device"].cpu().numpy()),
                  f"padded wave matrix {n} rows: device != host")
            _, up = turns(lambda: torch.from_numpy(view.padded_wave_matrix()[0]).to(dev),
                          lambda: None)
            print(f"records padded matrix {n} rows ({'ragged 192..%d' % WAVE_LEN if ragged else 'whole rows'}"
                  f", {pool.nbytes} pool bytes; {smi}): device = host; ms, mean of 2 in turns: "
                  f"host {ms['host']} (with its upload {up['host']}), device (pool upload and "
                  f"gather) {ms['device']}", flush=True)


def stream_rows(name: str, table):
    """A merged stream or a static table of ``name`` in one row order: the
    hit tables by (record_id, position), the event tables by event_index."""
    a = table.to_numpy()
    if name in ("hit", "hit_threshold"):
        return table[np.lexsort((a["position"], a["record_id"]))]
    return table[np.argsort(a["event_index"], kind="stable")]


def check_chunks(ref: list, out: list, tag: str, exact: bool = True) -> float:
    """Two chunk streams chunk for chunk: the same (start, end) windows and
    the same tables, bit for bit or (``exact`` False) ints exactly and f32
    within ATOL/RTOL. Returns the largest f32 |diff|."""
    check(len(ref) == len(out) > 0, f"{tag}: {len(out)} chunks, expected {len(ref)}")
    worst = 0.0
    for i, (r, o) in enumerate(zip(ref, out)):
        check((r.start, r.end) == (o.start, o.end), f"{tag} chunk {i}: window "
              f"{(o.start, o.end)} != {(r.start, r.end)}")
        if exact:
            check_identical(r.data, o.data, f"{tag} chunk {i}")
        else:
            worst = max(worst, compare_tables(r.data, o.data, f"{tag} chunk {i}")[0])
    return worst


def streaming_phase(dev, smi: str, kernels: dict, daq: str, source: str,
                    cpu_source: str) -> dict:
    """Slice 11's main path: chunked streaming over the ingest route's files
    (``source``, N_INGEST waveforms, linked under a fresh run name) by a
    Context with ``get_profile("streaming")``. For each of STREAM_NAMES,
    ``get_stream(run, name, executor_type="device")`` at the default
    chunk_size, cold and then STREAM_WARM_RUNS warm runs: K2 (hit) and K3 (hit_threshold)
    launch once per chunk and nothing else launches; every chunk holds host
    columns; the merged stream = the static table bit for bit (hit and
    hit_threshold with a left halo of one wave); the device executor = the
    host serial engine chunk for chunk (and, for hit, = the thread pool,
    which launches K2 once per chunk from 2 threads). Then
    ``get_data(run, "signal_peaks_stream")`` at its default chunk (64
    launches of K2) persists its chunks (the plugin set to
    save_when="always"), a second get_data reads them back from the cache
    and equals the first, and STREAM_WARM_RUNS warm runs with its cache cleared; the
    memory allocated after each stream stays flat; one warm hit stream
    under torch.profiler. Last, the ``cpu_source`` run (N_INGEST_CPU) on the
    card against the port's CPU Context, chunk for chunk at 4,096 rows a
    chunk. Returns the launch counts of each stream's first run."""
    from waveformanalysis_tpu_torch.context.context import Context
    from waveformanalysis_tpu_torch.dtypes import chunk as C
    from waveformanalysis_tpu_torch.plugins.device_stream import DeviceKernelStream
    from waveformanalysis_tpu_torch.plugins.plugin_sets import get_profile
    from waveformanalysis_tpu_torch.plugins.streaming import (
        StreamingConfig,
        get_streaming_context,
    )

    card = on_card(dev)

    def sync() -> None:
        if card:
            torch.cuda.synchronize(dev)

    def held() -> int:
        return torch.cuda.memory_allocated(dev) if card else 0

    def reset() -> None:
        for fn in kernels.values():
            fn.launches = 0

    def check_launches(name: str, n_chunks: int, tag: str) -> dict:
        got = {k: fn.launches for k, fn in kernels.items()}
        if card:
            want = {k: n_chunks if STREAM_KERNEL.get(name) == k else 0 for k in kernels}
            check(got == want, f"{tag}: launches {got}, expected {want}")
        return got

    def timed(call) -> tuple:
        reset()
        sync()
        t0 = time.perf_counter()
        chunks = list(call())
        sync()
        return chunks, time.perf_counter() - t0

    def walls_text(walls: list, n: int) -> str:
        med = statistics.median(walls[1:])
        return (f"cold {walls[0] * 1e3:.1f} ms, warm median of {len(walls) - 1} "
                f"{med * 1e3:.1f} ms = {n / med:.0f} waveforms/s (warm runs "
                f"{[round(w * 1e3, 1) for w in walls[1:]]} ms)")

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        ctx = ingest_context(Context, get_profile("streaming"), daq, f"{tmp}/stream", dev.type)
        run = link_run(daq, source, "stream0")
        sc = get_streaming_context(ctx)
        st = ctx.get_data(run, "st_waveforms")
        n = len(st)
        ctx.get_data(run, "filtered_waveforms")
        halo = {"required_halo_left_ns": float(WAVE_LEN * int(C._col(st, "dt")[0]))}
        del st
        static, static_ms = {}, {}
        for name in STREAM_NAMES:  # the static tables, their inputs cached:
            for i in range(2):  # cold, then warm with its cache cleared
                if i:
                    ctx.flush_saves()
                    ctx.clear_cache_for(run, name)
                t0 = time.perf_counter()
                static[name] = ctx.get_data(run, name)
                sync()
                static_ms.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        ctx.flush_saves()
        n_chunks = -(-n // STREAM_CHUNK)
        sync()
        memory = [held()]
        for name in STREAM_NAMES:
            kw = halo if name in ("hit", "hit_threshold") else {}
            walls, phases = [], []
            for i in range(1 + STREAM_WARM_RUNS):  # cold, then the warm runs
                ctx.profiler.reset()
                chunks, wall = timed(lambda: sc.get_stream(run, name, executor_type="device",
                                                           **kw))
                walls.append(wall)
                phases.append({k.rsplit(".", 1)[1]: v["total_s"] for k, v in
                               ctx.profiler.stats().items() if k.startswith("stream.device.")})
                got = check_launches(name, n_chunks, f"stream {name} run {i}")
                check(len(chunks) == n_chunks, f"stream {name}: {len(chunks)} chunks, "
                      f"expected {n_chunks}")
                check(all(isinstance(v, np.ndarray) for c in chunks
                          for v in c.data.columns.values()),
                      f"stream {name}: a chunk holds a column on the device")
                memory.append(held())
                if i == 0:
                    first, launches[name] = chunks, got
                del chunks
            check_identical(stream_rows(name, static[name]),
                            stream_rows(name, sc.merge_stream(first, sort=False)),
                            f"stream {name} merged")
            adapter = DeviceKernelStream.for_data_name(ctx, name)
            cfg = StreamingConfig.resolve(ctx, adapter)
            for key, value in kw.items():
                setattr(cfg, key, value)
            check_chunks(first, list(adapter._compute_serial(
                ctx, run, adapter.input_stream(ctx, run, cfg), cfg)),
                f"stream {name} device executor vs host serial")
            pool, halo_txt = "", f", left halo {kw[next(iter(kw))]:g} ns" if kw else ""
            if name == "hit":  # the host thread pool launching K2 from 2 threads
                cfg.parallel, cfg.max_workers = True, 2
                par, t_par = timed(lambda: adapter._compute_parallel(
                    ctx, run, adapter.input_stream(ctx, run, cfg), cfg))
                check_launches(name, n_chunks, "stream hit thread pool")
                check_chunks(first, par, "stream hit thread pool vs device executor")
                pool = (f"; the thread pool (2 workers) = the device executor chunk for "
                        f"chunk, K2 x{n_chunks} from 2 threads, {t_par * 1e3:.1f} ms")
                del par
            print(f"main path 11 stream {name} {n}x{WAVE_LEN} ({smi}): get_stream(run, "
                  f"{name!r}, executor_type='device'{halo_txt}) "
                  f"{n_chunks} chunks of {STREAM_CHUNK}, launches {nonzero(got)}; merged = the static "
                  f"table bit for bit ({len(static[name])} rows); = the host serial engine "
                  f"chunk for chunk{pool}; {walls_text(walls, n)}; warm phases ms "
                  f"{ {k: round(statistics.median(p[k] for p in phases[1:]) * 1e3, 1) for k in phases[1]} }"
                  f"; static get_data cold {static_ms[name][0]:.1f} ms, warm "
                  f"{static_ms[name][1]:.1f} ms", flush=True)
            del first

        # signal_peaks_stream through get_data: its chunks persist as they
        # stream (the JAX package's plugin never saves; a user keeps its
        # chunks with save_when="always") and a second get_data reads them
        plugin = ctx.get_plugin("signal_peaks_stream")
        plugin.save_when = "always"
        sp_chunks = -(-n // SIGNAL_PEAKS_CHUNK)
        walls = []
        for i in range(1 + STREAM_WARM_RUNS):
            if i:
                ctx.clear_cache_for(run, "signal_peaks_stream")
            chunks, wall = timed(lambda: ctx.get_data(run, "signal_peaks_stream"))
            walls.append(wall)
            got = check_launches("signal_peaks_stream", sp_chunks, f"signal_peaks_stream run {i}")
            check(len(chunks) == sp_chunks, f"signal_peaks_stream: {len(chunks)} chunks")
            memory.append(held())
            if i == 0:
                first, launches["signal_peaks_stream"] = chunks, got
        t0 = time.perf_counter()
        cached = ctx.get_data(run, "signal_peaks_stream")
        t_read = time.perf_counter() - t0
        streamed = C._concat([c.data for c in first]).to_numpy()
        cached = cached.to_numpy() if hasattr(cached, "to_numpy") else np.asarray(cached)
        check(cached.dtype == streamed.dtype and len(cached) == len(streamed) and all(
            np.array_equal(cached[f], streamed[f]) for f in streamed.dtype.names),
            "signal_peaks_stream: the cached table != the streamed chunks")
        print(f"main path 11 signal_peaks_stream {n}x{WAVE_LEN} ({smi}): get_data(run, "
              f"'signal_peaks_stream') on filtered_waveforms, {sp_chunks} chunks of "
              f"{SIGNAL_PEAKS_CHUNK}, launches {nonzero(launches['signal_peaks_stream'])}, "
              f"{len(streamed)} hits persisted chunk by chunk; a second get_data read "
              f"them from the cache in {t_read * 1e3:.1f} ms, = the streamed chunks bit for "
              f"bit; {walls_text(walls, n)} (each with its save; cache cleared before the "
              f"warm runs)", flush=True)
        del first, chunks, cached, streamed
        sync()
        memory.append(held())
        check(max(memory) - min(memory) <= 16 << 20, f"streaming: memory allocated after "
              f"each stream {memory} B is not flat")
        print(f"main path 11 memory allocated before the streams and after each "
              f"({len(memory) - 1} streams): {sorted(set(memory))} B, flat", flush=True)
        if card:
            ours = profile_call(ctx, lambda: list(sc.get_stream(
                run, "hit", executor_type="device", **halo)),
                f"stream hit {n}x{WAVE_LEN}, one warm run", smi)
            check(any("peaks" in k for k in ours), f"stream hit profile: kernels {ours}")
        ctx.flush_saves()
        del ctx, sc, static

        # the card's chunks against the port's CPU Context's
        cmp_run = link_run(daq, cpu_source, "stream_cmp")
        both = [ingest_context(Context, get_profile("streaming"), daq, f"{tmp}/cmp_{d}", d)
                for d in ("cpu", dev.type)]
        worst = (0.0, "")
        for name in STREAM_NAMES + ("signal_peaks_stream",):
            kw = halo if name in ("hit", "hit_threshold") else {}
            if name == "signal_peaks_stream":
                got = [list(c.get_data(cmp_run, name)) for c in both]
            else:
                got = [list(get_streaming_context(c).get_stream(
                    cmp_run, name, chunk_size=STREAM_CPU_CHUNK, executor_type="device", **kw))
                    for c in both]
            worst = max(worst, (check_chunks(*got, f"stream {name} card vs CPU", exact=False),
                                name))
        print(f"main path 11 at {N_INGEST_CPU}x{WAVE_LEN}: the card's chunks of "
              f"{list(STREAM_NAMES) + ['signal_peaks_stream']} (chunks of {STREAM_CPU_CHUNK}) = "
              f"the CPU Context's chunk for chunk (windows exact, ints exact, max |f32 diff| "
              f"{worst[0]:.3g} in {worst[1]})", flush=True)
        for c in both:
            c.flush_saves()
    return launches


SURFACE_RUNS = 2  # fresh runs of the server's batched request


def short_tmpdir() -> str:
    """A fresh directory whose path leaves room for a unix socket name
    (about 107 bytes): under $TMPDIR, or /tmp where $TMPDIR is too long."""
    d = tempfile.mkdtemp(prefix="wfa")
    if len(d) > 90:
        Path(d).rmdir()
        d = tempfile.mkdtemp(prefix="wfa", dir="/tmp")
    return d


def csv_matches(ref, path: Path, tag: str) -> float:
    """A CSV the CLI wrote against the DataFrame it came from: the columns,
    integer columns and the integer cells of per-event arrays exactly,
    floats within ATOL/RTOL (NaN where NaN). Returns the largest float
    |diff|."""
    import pandas as pd

    got = pd.read_csv(path)
    check(list(got.columns) == list(ref.columns) and len(got) == len(ref),
          f"{tag}: columns {list(got.columns)} x {len(got)} rows")
    worst = 0.0
    for col in ref.columns:
        a = ref[col]
        if a.dtype == object:  # per-event arrays, written as numpy's text
            x = np.concatenate([np.asarray(c).ravel() for c in a])
            y = np.concatenate([np.fromstring(c.strip("[]"), sep=" ") for c in got[col]])
            check(x.shape == y.shape, f"{tag}.{col}: cell lengths differ")
        else:
            x, y = a.to_numpy(), got[col].to_numpy()
        if np.issubdtype(x.dtype, np.floating):
            check(bool(np.isclose(y, x, atol=ATOL, rtol=RTOL, equal_nan=True).all()),
                  f"{tag}.{col}: values outside atol {ATOL} / rtol {RTOL}")
            d = np.abs(y - x.astype(np.float64))
            if np.isfinite(d).any():
                worst = max(worst, float(np.nanmax(d)))
        else:
            check(np.array_equal(y, x), f"{tag}.{col}: integers differ")
    return worst


def surface_phase(dev, smi: str, kernels: dict, daq: str, source: str,
                  cpu_source: str) -> dict:
    """Slice 12, the surface a user starts from, at the ingest route's width
    (``source``: N_INGEST waveforms of VX2730 files, linked under fresh run
    names). (1) ``PipelineServer`` on a thread over ingest_context's
    Context on ``dev`` (the default profile), driven through the socket
    with ``request``: ping; ``get_data(INGEST_REQUEST)`` cold and then warm
    on 2 fresh runs (K2 and K3 once each, nothing else); the same run
    again (a cache hit: no launch, no compute, no upload);
    ``get_data_batched`` over SURFACE_RUNS fresh runs (K3 once, K2 once a
    run); stats, flush and shutdown; each request's latency, the server's
    ``seconds``, rows and launches; the memory allocated after each request
    flat. (2) ``python -m waveformanalysis_tpu_torch.server`` as its own
    process, with no device flag (on the card), over a second storage: one
    ``get_data`` of a run linked to ``cpu_source`` (N_INGEST_CPU), flush,
    shutdown, exit 0, the kernel libraries loaded from build/kernels and
    none rebuilt; a Context on ``dev`` over that storage then loads every
    persisted table of the request with no compute and no launch, equal to
    the port's CPU Context's (compare_ingest). (3) ``cli.main`` with
    ``--target df_paired --output <csv>`` and no device flag on a fresh
    run, timed: df_paired's plan (st_waveforms, basic_features, df,
    df_events) launches no K2/K3, and its peak device memory holds the
    waves; the CSV's rows = the server's df_paired of the same files. (4) ``cli_cache.main`` over the
    in-process server's storage: ``info --json`` and ``list --json`` (the
    entries per data name), ``diagnose --json`` healthy, ``clean --all
    --dry-run`` deleting nothing. Returns the launch counts of the server's
    cold get_data, its batched request and the CLI."""
    import contextlib
    import io
    import shutil

    from waveformanalysis_tpu_torch import cli, cli_cache
    from waveformanalysis_tpu_torch.context.context import Context
    from waveformanalysis_tpu_torch.plugins.plugin_sets import get_profile
    from waveformanalysis_tpu_torch.server import PipelineServer, request, wait_ready

    card = on_card(dev)
    device_flag = [] if card else ["--device", dev.type]  # the card is the default
    # ingest_context's config as --config-json carries it: s1_s2's width
    # ranges are tuples, which JSON cannot carry (the option refuses a
    # list), so they keep their defaults there
    run_config = {"n_channels": 2, "channel_metadata": {"defaults": {"polarity": "positive"}},
                  "hit": FILTER_ROUTES["A"][0]["hit"]}

    def held() -> int:
        if card:
            torch.cuda.synchronize(dev)
            return torch.cuda.memory_allocated(dev)
        return 0

    def reset() -> None:
        for fn in kernels.values():
            fn.launches = 0

    def counts() -> dict:
        return {k: fn.launches for k, fn in kernels.items()}

    def want(k2: int, k3: int) -> dict:
        return {k: {"peaks_scan": k2, "hits_scan": k3}.get(k, 0) for k in kernels}

    def computed(ctx) -> list:
        return sorted(k for k in ctx.profiler.stats() if k.startswith("plugin.")
                      or k.startswith("fusion."))

    out = {}
    sock_dir = short_tmpdir()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            # (1) the server in this process, on a thread
            ctx = ingest_context(Context, get_profile("cuda"), daq, f"{tmp}/srv", dev.type)
            sock = f"{sock_dir}/srv.sock"
            server = PipelineServer(ctx, sock)
            thread = threading.Thread(target=server.serve_forever, daemon=True)
            thread.start()
            check(wait_ready(sock, timeout=60.0), "the in-process server did not answer ping")
            runs = [link_run(daq, source, f"srv{i}") for i in range(3 + SURFACE_RUNS)]
            plan = [("ping", {"op": "ping"}, None),
                    ("get_data cold", {"op": "get_data", "run_id": runs[0],
                                       "names": INGEST_REQUEST}, want(1, 1)),
                    ("get_data warm 1", {"op": "get_data", "run_id": runs[1],
                                         "names": INGEST_REQUEST}, want(1, 1)),
                    ("get_data warm 2", {"op": "get_data", "run_id": runs[2],
                                         "names": INGEST_REQUEST}, want(1, 1)),
                    ("get_data hit", {"op": "get_data", "run_id": runs[2],
                                      "names": INGEST_REQUEST}, want(0, 0)),
                    ("get_data_batched", {"op": "get_data_batched", "run_ids": runs[3:],
                                          "names": INGEST_REQUEST},
                     want(SURFACE_RUNS, 1)),
                    ("stats", {"op": "stats"}, None), ("flush", {"op": "flush"}, None)]
            lines, memory, rec = [], [], {}
            for tag, req, expect in plan:
                reset()
                ctx.profiler.reset()
                t0 = time.perf_counter()
                resp = request(sock, req)
                rt = time.perf_counter() - t0
                got = counts()
                check(resp.get("ok") is True, f"server {tag}: {resp}")
                rows = None
                if expect is not None:
                    memory.append(held())
                    if card:
                        check(got == expect, f"server {tag}: launches {got}, expected {expect}")
                    res = resp["results"]
                    if req["op"] == "get_data_batched":
                        rows = {r: {n: d["rows"] for n, d in res[r].items()} for r in res}
                        keys = {(r, n): d["key"] for r in res for n, d in res[r].items()}
                    else:
                        rows = {n: d["rows"] for n, d in res.items()}
                        keys = {(req["run_id"], n): d["key"] for n, d in res.items()}
                    check(all(ctx.key_for(r, n) == k for (r, n), k in keys.items()),
                          f"server {tag}: a key differs from key_for")
                    if tag == "get_data hit":
                        check(computed(ctx) == [], f"server {tag}: computed {computed(ctx)}")
                        check(rows == rec["get_data warm 2"]["rows"], f"server {tag}: rows")
                    elif tag == "get_data cold":
                        out["server_get_data"] = got
                    elif tag == "get_data_batched":
                        out["server_batched"] = got
                rec[tag] = {"ms": rt * 1e3, "server_ms": resp.get("seconds", 0.0) * 1e3,
                            "rows": rows}
                lines.append(f"{tag}: {rt * 1e3:.1f} ms (server {rec[tag]['server_ms']:.1f})"
                             + (f", launches {nonzero(got)}, rows {rows}" if expect else ""))
            df_paired = ctx.get_data(runs[0], "df_paired")
            t0 = time.perf_counter()
            bye = request(sock, {"op": "shutdown"})
            t_bye = time.perf_counter() - t0
            thread.join(timeout=120.0)
            check(bye.get("bye") is True and not thread.is_alive(),
                  "the in-process server did not shut down")
            check(max(memory) - min(memory) <= 16 << 20, f"server: memory allocated after "
                  f"each request {memory} B is not flat")
            warm = statistics.median(rec[f"get_data warm {i}"]["ms"] for i in (1, 2))
            overhead = [rec[t]["ms"] - rec[t]["server_ms"] for t in rec if t.startswith("get")]
            n = len(ctx.get_data(runs[0], "st_waveforms"))
            print(f"main path 12 server in-process {n}x{WAVE_LEN} ({smi}): "
                  + "; ".join(lines) + f"; shutdown {t_bye * 1e3:.1f} ms; get_data warm median "
                  f"{warm:.1f} ms = {n / warm * 1e3:.0f} waveforms/s; protocol overhead "
                  f"(round trip - server seconds) {[round(x, 2) for x in overhead]} ms; memory "
                  f"allocated after each request {memory} B", flush=True)
            out["server"] = rec

            # (2) the server as its own process, on the card by default
            store = f"{tmp}/proc"
            sock2 = f"{sock_dir}/proc.sock"
            built = {p.name: p.stat().st_mtime_ns for p in (ROOT / "build" / "kernels").glob("*")}
            cmd = [sys.executable, "-m", "waveformanalysis_tpu_torch.server", "--socket", sock2,
                   "--storage-dir", store, "--data-root", daq, "--config-json",
                   json.dumps(run_config), *device_flag]
            run = link_run(daq, cpu_source, "srvcmp")
            t0 = time.perf_counter()
            proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
            try:
                ready = wait_ready(sock2, timeout=300.0)
                t_ready = time.perf_counter() - t0
                if not ready:
                    proc.kill()
                    fail(f"the server process did not answer ping in 300 s: "
                         f"{proc.communicate(timeout=60)[1][-3000:]}")
                t0 = time.perf_counter()
                resp = request(sock2, {"op": "get_data", "run_id": run, "names": INGEST_REQUEST})
                t_get = time.perf_counter() - t0
                check(resp.get("ok") is True, f"server process get_data: {resp}")
                check(request(sock2, {"op": "flush"}).get("ok") is True, "server process flush")
                check(request(sock2, {"op": "shutdown"}).get("bye") is True,
                      "server process shutdown")
                rc = proc.wait(timeout=120)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            stdout, stderr = proc.communicate()
            check(rc == 0, f"the server process exited {rc}: {stderr[-3000:]}")
            check("listening on" in stdout, f"the server process said {stdout!r}")
            after = {p.name: p.stat().st_mtime_ns for p in (ROOT / "build" / "kernels").glob("*")}
            check(after == built, "the server process rebuilt a kernel library: "
                  f"{sorted(set(after.items()) ^ set(built.items()))}")
            config = dict(run_config, data_root=daq, daq_adapter="vx2730", show_progress=False)
            loader = Context(storage_dir=store, config=dict(config, device=dev.type))
            loader.register(*get_profile("cuda"))
            persisted = [n for n in INGEST_COMPARED if n != "filtered_waveforms"]
            check(all(resp["results"][n]["key"] == loader.key_for(run, n) for n in INGEST_REQUEST),
                  "the server process's keys differ from key_for")
            reset()
            for name in persisted:
                loader.get_data(run, name)
            check(computed(loader) == [] and all(v == 0 for v in counts().values()),
                  f"loading the served tables computed {computed(loader)}, launched {counts()}")
            cpu = Context(storage_dir=f"{tmp}/proc_cpu", config=dict(config, device="cpu"))
            cpu.register(*get_profile("cuda"))
            cpu.get_data(run, INGEST_REQUEST)
            err, where = compare_ingest(cpu, loader, run, names=persisted)
            print(f"main path 12 server process (python -m waveformanalysis_tpu_torch.server, "
                  f"no device flag; {smi}): ready {t_ready:.2f} s after launch; get_data of "
                  f"{len(loader.get_data(run, 'st_waveforms'))}x{WAVE_LEN} {t_get * 1e3:.1f} ms "
                  f"(server "
                  f"{resp['seconds'] * 1e3:.1f}), rows "
                  f"{ {n: d['rows'] for n, d in resp['results'].items()} }; exit 0, no kernel "
                  f"rebuilt; a second Context loaded {persisted} with no compute and no launch, "
                  f"= the CPU Context's (max |f32 diff| {err:.3g}, {where})", flush=True)
            out["process"] = {"ready_s": t_ready, "get_data_ms": t_get * 1e3,
                              "server_ms": resp["seconds"] * 1e3}
            for c in (loader, cpu):
                c.flush_saves()
            del loader, cpu

            # (3) waveform-process: df_paired of a fresh full-width run to CSV
            run = link_run(daq, source, "clirun")
            csv = Path(tmp, "out", "df_paired.csv")
            argv = ["--run-name", run, "--data-root", daq, "--storage-dir", f"{tmp}/cli",
                    "--n-channels", "2", "--config-json", json.dumps(run_config), "--target",
                    "df_paired", "--output", str(csv), "--quiet", *device_flag]
            reset()
            said = io.StringIO()
            if card:
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            base = held()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(said):
                rc = cli.main(argv)
            t_cli = time.perf_counter() - t0
            got = counts()
            peak = torch.cuda.max_memory_allocated(dev) - base if card else 0
            check(rc == 0 and said.getvalue().startswith(f"wrote {len(df_paired)} rows"),
                  f"waveform-process exited {rc}: {said.getvalue()!r}")
            if card:  # df_paired's plan holds basic_features, on the card, and no K2/K3
                check(got == want(0, 0) and peak >= n * WAVE_LEN * 2,
                      f"waveform-process: launches {got}, peak {peak} B above its start: "
                      f"expected no kernel and the waves on the card")
            err = csv_matches(df_paired, csv, "waveform-process df_paired")
            # the CSV formatting alone, on a slice of the same frame (the
            # per-event array cells are formatted one by one on the host)
            part = df_paired.iloc[:N_INGEST_CPU]
            t_csv = timeit_s(lambda: part.to_csv(Path(tmp, "part.csv"), index=False))
            print(f"main path 12 waveform-process (cli.main, no device flag; {smi}): "
                  f"--target df_paired --output csv on {n}x{WAVE_LEN} in {t_cli:.2f} s, "
                  f"launches {nonzero(got)} (df_paired's plan runs no K2/K3), peak device "
                  f"memory {peak} B above its start; {len(df_paired)} rows = the server's "
                  f"df_paired of the same files (max |f32 diff| {err:.3g}; "
                  f"{csv.stat().st_size} bytes); to_csv of its first {len(part)} rows alone "
                  f"{t_csv * 1e3:.1f} ms", flush=True)
            out["cli"] = got
            out["cli_s"] = t_cli

            # (4) waveform-cache over the in-process server's storage
            def cache(*args) -> tuple:
                text = io.StringIO()
                with contextlib.redirect_stdout(text):
                    rc = cli_cache.main(["--storage-dir", f"{tmp}/srv", *args])
                return rc, text.getvalue()

            rc, info = cache("info", "--json")
            info = json.loads(info)
            rc_list, entries = cache("list", "--json")
            per_name: dict = {}
            for e in json.loads(entries):
                name = e["key"][len(e["run_id"]) + 1:]
                hint = name.endswith("-caphint")  # a capacity hint: metadata only
                name = name.rsplit("-", 2 if hint else 1)[0] + (" hints" if hint else "")
                per_name[name] = per_name.get(name, 0) + 1
            check(rc == rc_list == 0 and info["n_entries"] == sum(per_name.values()) > 0,
                  f"waveform-cache info/list: {info}")
            rc, diag = cache("diagnose", "--json")
            diag = json.loads(diag)
            check(rc == 0 and diag["is_healthy"] and not diag["corrupt"]
                  and not diag["orphan_payloads"] and not diag["orphan_metadata"],
                  f"waveform-cache diagnose: {diag}")
            rc, dry = cache("clean", "--all", "--dry-run")
            check(rc == 0 and json.loads(cache("info", "--json")[1])["n_entries"]
                  == info["n_entries"], "waveform-cache clean --all --dry-run deleted entries")
            print(f"main path 12 waveform-cache over the server's storage: info "
                  f"{info['n_entries']} entries, {info['total_mb']:.1f} MB, per data name "
                  f"{dict(sorted(per_name.items()))}; diagnose healthy ({diag['healthy']} "
                  f"checksums ok, no orphan, no corruption); clean --all --dry-run: "
                  f"{dry.splitlines()[0]}, nothing deleted", flush=True)
            del ctx, df_paired
    finally:
        shutil.rmtree(sock_dir, ignore_errors=True)
    return out


# the user plugin of phase 5n: a peak finder in the shape of hit, found on
# disk by PluginLoader and edited while the Context runs
UTILITY_PLUGIN = '''
from waveformanalysis_tpu_torch.plugins.base import Option
from waveformanalysis_tpu_torch.plugins.builtin.peak_finding import HitFinderPlugin


class UserHit(HitFinderPlugin):
    """A user's peak finder: hit's kernels with its own height threshold."""

    provides = "user_hit"
    version = "{version}"
    options = dict(HitFinderPlugin.options,
                   height=Option(default={height}, type=float, help="Minimum peak height"))
'''


def utilities_phase(dev, smi: str, kernels: dict, daq: str, source: str,
                    cpu_source: str, n: int) -> dict:
    """Slice 13, the user utilities, on the ingest phase's VX2730 files
    (``source``: ``n`` waveforms, 2 channels x INGEST_FILES files;
    ``cpu_source``: the N_INGEST_CPU run), each step timed with the launch
    counts reset before it. (1) ``parse_and_stack_files`` over the run's
    files (a thread a file): each channel's stack = the port's reader file
    by file, ``count_rows`` sums to ``n``, the parse rate. (2)
    ``WaveformPreviewer``: ``load_events`` and ``load_by_timestamp`` = the
    parsed rows, ``preview_features`` = NumPy's, ``summary``;
    ``preview_waveforms`` where matplotlib is installed. (3) df_events of a
    fresh run linked to ``source`` on a card Context and the four event
    filters on it; the same filters on the card's and the CPU Context's
    df_events of a run linked to ``cpu_source``, bit for bit. (4) On a
    fresh card Context: ``StraxContextAdapter(ctx).get_array(run, "hit")``
    (K2 once; = the Context's table), ``get_df``, ``search_field``;
    ``create_interactive_browser`` on a second fresh run (K2 once); that
    run's records and pool through ``_resolve_records_view`` (a record's
    wave is a parsed row); ``plot_records_waveforms``, ``browse(0)`` and
    ``ctx.plot_lineage("df_paired")`` saved as PNGs where matplotlib is
    installed, else plot_lineage's graph, layout and wire routes. (5)
    ``PluginLoader`` finds a user plugin (``user_hit``, a hit subclass, so
    the card runs K2 for it) in a temporary directory; after an edit of its
    file (a new version and height) ``PluginHotReloader`` re-registers it
    and invalidates its cache, and the next ``get_data`` launches K2 again
    and keeps fewer peaks. The memory allocated after the phase = before
    it, within 16 MB. Returns the launch counts of the df_events request,
    the strax adapter, the browser and the reloaded plugin."""
    import importlib.util

    import waveformanalysis_tpu_torch as wa
    from waveformanalysis_tpu_torch.context.context import Context
    from waveformanalysis_tpu_torch.plugins.plugin_sets import get_profile
    from waveformanalysis_tpu_torch.utils import event_filters as EF
    from waveformanalysis_tpu_torch.utils import io as uio
    from waveformanalysis_tpu_torch.utils import visualization as viz
    from waveformanalysis_tpu_torch.utils.preview import _resolve_records_view

    card = on_card(dev)
    mpl = importlib.util.find_spec("matplotlib") is not None
    if mpl:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

    def held() -> int:
        if card:
            torch.cuda.synchronize(dev)
            return torch.cuda.memory_allocated(dev)
        return 0

    def counts() -> dict:
        return {k: fn.launches for k, fn in kernels.items()}

    def want(k2: int) -> dict:
        return {k: k2 if k == "peaks_scan" else 0 for k in kernels}

    walls, launches, pngs = {}, {}, {}

    def step(tag: str, fn, expect=None):
        """fn() timed, with every launch count set to 0 before it."""
        for kernel in kernels.values():
            kernel.launches = 0
        t0 = time.perf_counter()
        out = fn()
        if card:
            torch.cuda.synchronize(dev)
        walls[tag] = time.perf_counter() - t0
        launches[tag] = counts()
        if expect is not None and card:
            check(launches[tag] == expect,
                  f"utilities {tag}: launches {launches[tag]}, expected {expect}")
        return out

    def png(name: str, draw) -> None:
        path = Path(tmp, f"{name}.png")
        step(name, lambda: draw(path), want(0))
        pngs[name] = path.stat().st_size if path.exists() else 0
        check(pngs[name] > 0, f"utilities {name}: {path.name} is empty")
        plt.close("all")

    t_phase = time.perf_counter()
    base = held()
    adapter = wa.get_adapter("vx2730")
    by_channel = adapter.scan_run(daq, source)
    files = [by_channel[ch] for ch in sorted(by_channel)]
    csv_bytes = sum(Path(f).stat().st_size for chan in files for f in chan)
    n_threads = min(sum(len(chan) for chan in files), 16)  # parse_and_stack_files' pool
    with tempfile.TemporaryDirectory() as tmp:
        # (1) the flat-pool parse
        stacked = step("parse_and_stack_files", lambda: uio.parse_and_stack_files(files),
                       want(0))
        reader = adapter.format_reader
        for ch, chan in enumerate(files):
            ref = np.vstack([reader.read_file(f, is_first_file=(i == 0))
                             for i, f in enumerate(chan)])
            check(stacked[ch] is not None and stacked[ch].dtype == ref.dtype
                  and np.array_equal(stacked[ch], ref),
                  f"parse_and_stack_files: channel {ch} != the reader's files")
        rows = uio.count_rows(files)
        check(sum(rows) == n, f"count_rows {rows} does not sum to {n}")
        samples = [adapter.extract_and_convert(a)["samples"] for a in stacked]
        del stacked, ref
        rate = csv_bytes / walls["parse_and_stack_files"] / 1e6

        # (2) the previewer, straight from the files
        pv = wa.WaveformPreviewer(daq, source)
        start, k = min(1000, n // 4), 64
        ev = step("load_events", lambda: pv.load_events(0, start=start, n_events=k), want(0))
        check(np.array_equal(np.asarray(ev["wave"]),
                             samples[0][start:start + k].astype(np.float32)),
              "load_events != the parsed rows")
        lo, hi = 100 * INGEST_DT_PS, (100 + k) * INGEST_DT_PS
        win = step("load_by_timestamp", lambda: pv.load_by_timestamp(1, lo, hi), want(0))
        check(np.array_equal(np.asarray(win["wave"]),
                             samples[1][100:100 + k].astype(np.float32)),
              "load_by_timestamp != the parsed rows")
        feats = step("preview_features", lambda: pv.preview_features(ev), want(0))
        sig = np.asarray(ev["baseline"])[:, None] - np.asarray(ev["wave"], dtype=np.float64)
        check(np.array_equal(feats["height"], sig.max(axis=1))
              and np.array_equal(feats["area"], sig.sum(axis=1)), "preview_features != NumPy's")
        summary = pv.summary(ev)
        check(summary.startswith(f"{k} events"), f"summary: {summary!r}")
        if mpl:
            png("preview_waveforms", lambda path: wa.preview_waveforms(
                source, 0, event_range=(start, start + 16), data_root=daq,
                save_path=str(path)))
        print(f"main path 13 parse and preview ({smi}; matplotlib: "
              f"{'present' if mpl else 'absent'}): parse_and_stack_files over {n}x{WAVE_LEN} "
              f"in {sum(len(c) for c in files)} files ({csv_bytes} B) "
              f"{walls['parse_and_stack_files'] * 1e3:.1f} ms with {n_threads} threads = "
              f"{rate:.0f} MB/s, = the reader file by file, count_rows {rows}; "
              f"WaveformPreviewer load_events {walls['load_events'] * 1e3:.1f} ms, "
              f"load_by_timestamp {walls['load_by_timestamp'] * 1e3:.1f} ms (= the parsed "
              f"rows), preview_features = NumPy's; summary {summary!r}", flush=True)

        # (3) the event filters on the card's df_events, then card = CPU
        ctx = ingest_context(Context, get_profile("cuda"), daq, f"{tmp}/card", dev.type)
        events = step("df_events", lambda: ctx.get_data(link_run(daq, source, "util0"),
                                                        "df_events"))
        cut = float(np.median([np.sum(a) for a in events["areas"]]))
        filters = {"filter_by_n_hits": lambda df: EF.filter_by_n_hits(df, min_hits=2),
                   "filter_by_channels": lambda df: EF.filter_by_channels(df, [0, 1]),
                   "filter_coincidence": lambda df: EF.filter_coincidence(df, 0, 1,
                                                                          max_dt_ns=25.0),
                   "filter_by_area": lambda df: EF.filter_by_area(df, min_total_area=cut)}
        kept = {}
        for name, fn in filters.items():
            got = step(name, lambda fn=fn: fn(events), want(0))
            check(0 < len(got) <= len(events), f"{name} kept {len(got)} of {len(events)}")
            kept[name] = len(got)
        n_events = len(events)
        cmp_run = link_run(daq, cpu_source, "utilcmp")
        cpu = ingest_context(Context, get_profile("cuda"), daq, f"{tmp}/cpu", "cpu")
        ref_events = cpu.get_data(cmp_run, "df_events")
        got_events = ctx.get_data(cmp_run, "df_events")
        kept_cmp = {}
        for name, fn in filters.items():
            ref = fn(ref_events)
            check(len(ref) > 0, f"{name}: nothing kept of the {cmp_run} run")
            check_identical(ref, fn(got_events), f"utilities {name} card vs CPU")
            kept_cmp[name] = len(ref)
        for c in (cpu, ctx):
            c.flush_saves()
        print(f"main path 13 event filters ({smi}): df_events of {n}x{WAVE_LEN} on the card "
              f"{walls['df_events'] * 1e3:.1f} ms (launches {nonzero(launches['df_events'])}), "
              f"{n_events} events; kept "
              + ", ".join(f"{k} {kept[k]} in {walls[k] * 1e3:.1f} ms" for k in filters)
              + f"; on the {len(ref_events)} events of a run linked to {cpu_source!r} the "
              f"card's rows = the CPU Context's bit for bit ({kept_cmp})", flush=True)
        del cpu, ctx, events, ref_events, got_events, ref

        # (4) the strax facade, the browser, the records view and the lineage
        ctx = ingest_context(Context, get_profile("cuda"), daq, f"{tmp}/fresh", dev.type)
        strax = wa.StraxContextAdapter(ctx)
        run = link_run(daq, source, "util1")
        arr = step("get_array", lambda: strax.get_array(run, "hit"), want(1))
        check(isinstance(arr, np.ndarray) and len(arr) > 0
              and np.array_equal(arr, ctx.get_data(run, "hit").to_numpy()),
              "StraxContextAdapter.get_array(hit) != get_data(hit)")
        frame = step("get_df", lambda: strax.get_df(run, "hit"), want(0))
        check(len(frame) == len(arr) and "height" in frame.columns, "get_df(hit)")
        check("hit" in strax.search_field("height"), "search_field('height')")
        run2 = link_run(daq, source, "util2")
        browse = step("create_interactive_browser",
                      lambda: wa.create_interactive_browser(ctx, run2), want(1))
        step("records", lambda: ctx.get_data(run2, ["records", "wave_pool"]))
        rv = step("_resolve_records_view", lambda: _resolve_records_view(ctx, run2), want(0))
        check(len(rv) == n, f"RecordsView holds {len(rv)} records, not {n}")
        wave = rv.waves(int(np.asarray(rv.records["record_id"])[0]))
        check(wave.size == WAVE_LEN and any(np.array_equal(wave, s[0]) for s in samples),
              "the first record's wave is not a parsed row")
        if mpl:
            png("browse", lambda path: browse(0).savefig(path))
            png("plot_records_waveforms", lambda path: wa.plot_records_waveforms(
                ctx, run2, save_path=str(path)))
            png("plot_lineage", lambda path: ctx.plot_lineage("df_paired").figure.savefig(path))
            drawn = f"PNGs {pngs} B"
        else:  # plot_lineage_labview's data path: the graph, its layout, the wires

            def lineage_layout():
                nodes, edges, info = viz.lineage_to_graph(ctx.get_lineage("df_paired"),
                                                          "df_paired")
                viz._attach_context_details(info, ctx)
                style = viz.LineageStyle()
                heights = {v: viz.estimate_node_height(v, info[v], style) for v in nodes}
                pos = viz.scaled_positions(viz.layered_layout(nodes, edges), heights, style)
                boxes = viz._node_boxes(pos, heights, style)
                half = style.node_width / 2
                return nodes, edges, [viz.route_edge((pos[s][0] + half, pos[s][1]),
                                                     (pos[d][0] - half, pos[d][1]), boxes,
                                                     {s, d}) for s, d in edges]

            nodes, edges, wires = step("plot_lineage layout", lineage_layout, want(0))
            check(len(nodes) > 5 and len(edges) >= len(nodes) - 1,
                  f"df_paired's lineage graph: {len(nodes)} nodes, {len(edges)} edges")
            drawn = (f"no render; plot_lineage's layout of df_paired: {len(nodes)} nodes, "
                     f"{len(edges)} wires ({sum(w is not None for w in wires)} orthogonal) in "
                     f"{walls['plot_lineage layout'] * 1e3:.1f} ms")
        print(f"main path 13 strax facade, browser, records view, lineage ({smi}): "
              f"StraxContextAdapter.get_array(run, 'hit') {walls['get_array'] * 1e3:.1f} ms, "
              f"{len(arr)} rows = get_data (launches {nonzero(launches['get_array'])}), get_df "
              f"{walls['get_df'] * 1e3:.1f} ms; create_interactive_browser on a fresh run "
              f"{walls['create_interactive_browser'] * 1e3:.1f} ms (launches "
              f"{nonzero(launches['create_interactive_browser'])}); records + wave_pool "
              f"{walls['records'] * 1e3:.1f} ms, RecordsView of {len(rv)} records on the host "
              f"{walls['_resolve_records_view'] * 1e3:.1f} ms; {drawn}", flush=True)

        # (5) a user plugin found on disk, edited and hot-reloaded
        plugin_dir = Path(tmp, "user_plugins")
        plugin_dir.mkdir()
        src = plugin_dir / "user_hit.py"
        src.write_text(UTILITY_PLUGIN.format(version="1.0.0", height=80.0))
        loader = wa.PluginLoader()
        found = [c for c in loader.discover_directory(plugin_dir) if c.provides == "user_hit"]
        check(len(found) == 1 and not loader.report.failures,
              f"PluginLoader: {loader.report.summary()}")
        ctx.register(found[0]())
        ctx.set_config({"user_hit": {key: v for key, v in FILTER_ROUTES["A"][0]["hit"].items()
                                     if key != "height"}})
        reloader = wa.enable_hot_reload(ctx)
        first = step("user_hit", lambda: ctx.get_data(run2, "user_hit"), want(1))
        key1 = ctx.key_for(run2, "user_hit")
        time.sleep(0.02)  # a new mtime as well as new content
        src.write_text(UTILITY_PLUGIN.format(version="2.0.0", height=300.0))
        reloaded = step("check_and_reload", reloader.check_and_reload, want(0))
        check(reloaded == ["user_hit"] and ctx.get_plugin("user_hit").version == "2.0.0"
              and ctx.key_for(run2, "user_hit") != key1,
              f"hot reload re-registered {reloaded}")
        second = step("user_hit reloaded", lambda: ctx.get_data(run2, "user_hit"), want(1))
        check(0 < len(second) < len(first),
              f"the reloaded user_hit kept {len(second)} peaks, {len(first)} before")
        print(f"main path 13 plugin loader and hot reload ({smi}): user_hit found on disk; "
              f"get_data {walls['user_hit'] * 1e3:.1f} ms, {len(first)} peaks (launches "
              f"{nonzero(launches['user_hit'])}); edited (v2.0.0, height 300): "
              f"check_and_reload {walls['check_and_reload'] * 1e3:.1f} ms re-registered "
              f"{reloaded} and invalidated its cache; get_data "
              f"{walls['user_hit reloaded'] * 1e3:.1f} ms, {len(second)} peaks (launches "
              f"{nonzero(launches['user_hit reloaded'])})", flush=True)
        ctx.flush_saves()
        del ctx, reloader, strax, arr, frame, browse, rv, first, second, samples
    after = held()
    check(abs(after - base) <= 16 << 20,
          f"utilities: memory allocated {after} B after the phase, {base} B before")
    print(f"main path 13 user utilities: phase {time.perf_counter() - t_phase:.1f} s; memory "
          f"allocated {base} B before, {after} B after; step walls (ms) "
          f"{ {k: round(v * 1e3, 1) for k, v in walls.items()} }", flush=True)
    return {"df_events": launches["df_events"], "strax_get_array": launches["get_array"],
            "browser": launches["create_interactive_browser"],
            "hot_reload": launches["user_hit reloaded"]}


N_MESH_SHARDS = 8  # phase 5o's mesh: [cuda:0] * 8 on one card (parallel.spread_devices)
N_MESH_PLAIN = 65_536  # make_sharded_chain (the plain chain) on the mesh
N_MESH_SORT = 262_144  # sharded_time_sort rows (sort_records: two boards, timestamp ties)
N_MESH_BATCH_RUNS = 4  # get_data_batched on the mesh: runs of N_EVENTS


def split_parts(bundle, part_size: int) -> list:
    """A records bundle as the records builder's parts: each (board, channel)'s rows
    in time order, cut every ``part_size`` rows, each part with its own
    pool."""
    from waveformanalysis_tpu_torch.processing import records_builder as RB

    rec = bundle.records
    group = np.asarray(rec["board"]).astype(np.int64) * 1024 + np.asarray(rec["channel"])
    parts = []
    for g in np.unique(group):
        rows = np.flatnonzero(group == g)
        for lo in range(0, len(rows), part_size):
            r = rec.select(rows[lo:lo + part_size])
            pool, offsets = RB.gather_pool(bundle.wave_pool, np.asarray(r["wave_offset"]),
                                           np.asarray(r["event_length"]))
            parts.append(RB.RecordsBundle(r.with_columns(wave_offset=offsets), pool))
    return parts


def mesh_phase(dev, smi: str, kernels: dict, daq: str, source: str, n: int,
               n_chain: int) -> dict:
    """Slice 14's main path on a mesh of N_MESH_SHARDS shards
    (``spread_devices``: the cards in blocks, so one card holds all 8).

    The sharded chains on ``make_batch(n_chain, WAVE_LEN)`` with bench.py's
    config: K1's and K7's steps launch their kernel once a shard, their
    per-event outputs = the one-device steps' bit for bit and their
    statistics = the sums over the one-device outputs in shard order; both
    timed beside the one-device steps in turns (CUDA events, median of 7, a
    fresh input each iteration); ``make_sharded_chain`` (no kernel) at
    N_MESH_PLAIN = the plain chain. The halo pipeline: a 3-point moving sum
    = the same sum over the whole array. ``sharded_time_sort`` on
    N_MESH_SORT rows with multi-board timestamp ties = ``np.lexsort``, and
    ``merge_records_parts(parts, mesh)`` on the records of the ``source``
    files, cut into the records builder's parts, = the host merge; both timed. The
    mesh Context: ``n`` injected waveforms with slice 2's route settings (all
    five members fused), cold one-device and mesh runs on the same waves
    (tables bit-identical, lineage keys equal), then warm runs in turns on
    fresh waves: K2, K3 and K4 once a shard, memory allocated after each
    mesh run flat; ``get_data_batched`` over N_MESH_BATCH_RUNS runs of
    N_EVENTS on the mesh (K2-K4 once a shard) = per-run one-device tables.
    A stream on the mesh: the ``source`` files' ``hit`` stream and
    ``signal_peaks_stream`` (executor_type "device") on the mesh = without
    it, chunk for chunk, and ``merge_stream(backend="device")`` = the host
    merge. Returns the launch counts of each mesh call."""
    from bench import make_batch
    from waveformanalysis_tpu_torch.context.context import Context
    from waveformanalysis_tpu_torch.dtypes import chunk as C
    from waveformanalysis_tpu_torch.models.full_chain import (
        CHAIN_OUT_KEYS,
        ChainConfig,
        make_chain,
        make_sharded_chain,
    )
    from waveformanalysis_tpu_torch.ops import chain_scan_cuda as csc
    from waveformanalysis_tpu_torch.ops import chain_tile_cuda as ctc
    from waveformanalysis_tpu_torch.parallel.mesh import make_mesh, spread_devices
    from waveformanalysis_tpu_torch.parallel.scan import make_sharded_pipeline
    from waveformanalysis_tpu_torch.parallel.sorted_merge import sharded_time_sort
    from waveformanalysis_tpu_torch.plugins.plugin_sets import get_profile
    from waveformanalysis_tpu_torch.plugins.streaming import get_streaming_context
    from waveformanalysis_tpu_torch.processing import records_builder as RB
    from waveformanalysis_tpu_torch.processing.loader import get_raw_files
    from waveformanalysis_tpu_torch.testing.fixtures import st_waveforms_from_waves

    card = on_card(dev)
    t_phase = time.perf_counter()

    def sync() -> None:
        if card:
            torch.cuda.synchronize(dev)

    def held() -> int:
        sync()
        return torch.cuda.memory_allocated(dev) if card else 0

    def reset() -> None:
        for fn in kernels.values():
            fn.launches = 0

    def counts(want: dict, tag: str) -> dict:
        got = {k: fn.launches for k, fn in kernels.items()}
        if card:
            full = {k: want.get(k, 0) for k in kernels}
            check(got == full, f"{tag}: launches {got}, expected {full}")
        return got

    def step_ms(fn) -> float:  # CUDA events on the card, the host clock here
        if card:
            return median_ms(fn)
        fn(0)
        return timeit_s(lambda: fn(1)) * 1e3

    def gathered(x) -> torch.Tensor:
        return torch.cat([s.to(dev) for s in x.shards])

    mesh = make_mesh(devices=spread_devices(dev, N_MESH_SHARDS))
    shards, m_rows = N_MESH_SHARDS, n_chain // N_MESH_SHARDS
    where = f"{shards} shards on {len(set(mesh.devices.flat))} device(s)"
    launches = {}

    # ---- the sharded chains -------------------------------------------------
    cfg = ChainConfig(use_derivative=False, peak_height=80.0, peak_prominence=50.0,
                      peak_width=2.0)
    w = torch.from_numpy(make_batch(n_chain, WAVE_LEN, seed=0)).to(dev)
    el = torch.full((n_chain,), WAVE_LEN, dtype=torch.int32, device=dev)
    bl = torch.full((n_chain,), 1000.0, device=dev)
    pol = torch.ones(n_chain, dtype=torch.int8, device=dev)
    steps = {"chain_scan": (csc.make_chain_scan(cfg), csc.make_sharded_chain_scan(mesh, cfg)),
             "chain_tile": (ctc.make_chain_tile(cfg), ctc.make_sharded_chain_tile(mesh, cfg))}
    launches["chain_step"] = {}
    for name, (one, sharded) in steps.items():
        ref = one(w, el, bl, pol)
        reset()
        out = sharded(w, el, bl, pol)
        sync()
        launches["chain_step"][name] = counts({name: shards}, f"sharded {name} step")[name]
        for k in CHAIN_OUT_KEYS:
            check(torch.equal(gathered(out[k]), ref[k]), f"sharded {name}: {k} != one device")
        parts = [ref["area"][i * m_rows:(i + 1) * m_rows].sum() for i in range(shards)]
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        label = ref["label"]
        want = {"n_s1": (label == 1).sum(dtype=torch.int32),
                "n_s2": (label == 2).sum(dtype=torch.int32), "total_area": total,
                "n_peak_overflow": ref["n_peak_overflow"], "n_hit_overflow": ref["n_hit_overflow"]}
        for k, v in want.items():
            check(torch.equal(out[k].to(dev), v), f"sharded {name}: {k} {out[k]} != {v}")
        # in turns: one device, sharded, sharded, one device
        t_one = step_ms(lambda k: one(w + k, el, bl + k, pol))
        t_sh = step_ms(lambda k: sharded(w + k, el, bl + k, pol))
        t_sh2 = step_ms(lambda k: sharded(w + k, el, bl + k, pol))
        t_one2 = step_ms(lambda k: one(w + k, el, bl + k, pol))
        print(f"main path 14 {name} {n_chain}x{WAVE_LEN} on {where} ({smi}): "
              f"make_sharded_{'chain_scan' if name == 'chain_scan' else 'chain_tile'} launches "
              f"{name} x{launches['chain_step'][name]}; every per-event output = the one-device "
              f"step's bit for bit; n_s1 {int(want['n_s1'])}, n_s2 {int(want['n_s2'])}, "
              f"total_area {float(total):.1f}, overflows = the sums over the one-device outputs "
              f"(bit for bit); step ms, median of 7 in turns (fresh input each iteration): one "
              f"device {t_one:.3f} / {t_one2:.3f}, sharded {t_sh:.3f} / {t_sh2:.3f}", flush=True)
        del ref, out
    wp, elp, blp, polp = (x[:N_MESH_PLAIN] for x in (w, el, bl, pol))
    ref = make_chain(cfg)(wp, elp, blp, polp)
    reset()
    out = make_sharded_chain(mesh, cfg)(wp, elp, blp, polp)
    counts({}, "make_sharded_chain")
    for k in CHAIN_OUT_KEYS:
        check(torch.equal(gathered(out[k]), ref[k]), f"make_sharded_chain: {k} != make_chain")
    check(int(out["n_s1"]) == int((ref["label"] == 1).sum()), "make_sharded_chain: n_s1")
    print(f"main path 14 make_sharded_chain {N_MESH_PLAIN}x{WAVE_LEN} on {where}: = make_chain "
          f"bit for bit, no kernel launch", flush=True)
    del w, el, bl, pol, wp, elp, blp, polp, ref, out

    # ---- the halo pipeline ---------------------------------------------------
    x = torch.from_numpy(np.random.default_rng(5).normal(0, 1, n_chain).astype(np.float32)).to(dev)

    def smooth(v, left_halo=None, right_halo=None):
        ext = torch.cat([left_halo, v, right_halo])
        return {"smoothed": ext[:-2] + ext[1:-1] + ext[2:], "total": v.sum()}

    out = make_sharded_pipeline(mesh, smooth, 1, ("smoothed", "total"), ("total",), halo=1)(x)
    zero = x.new_zeros(1)
    whole = smooth(x, zero, zero)["smoothed"]
    check(torch.equal(gathered(out["smoothed"]), whole), "halo pipeline != the whole array's sum")
    print(f"main path 14 halo pipeline {n_chain} f32 on {where}: 3-point moving sum = the same "
          f"sum over the whole array bit for bit", flush=True)
    del x, out, whole

    # ---- the sharded time sort and the records mesh merge ---------------------
    rec = sort_records(N_MESH_SORT, 2, seed=7)
    cols = {k: np.asarray(rec[k]) for k in rec.field_names}
    cols["row"] = np.arange(N_MESH_SORT, dtype=np.int64)
    keys = ("timestamp", "pid", "board", "channel")
    order = np.lexsort(tuple(cols[k] for k in reversed(keys)))
    t_sort, t_lex = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        got = sharded_time_sort(cols, keys, mesh)
        t_sort.append(time.perf_counter() - t0)
        t_lex.append(timeit_s(lambda: np.lexsort(tuple(cols[k] for k in reversed(keys)))))
    for k in cols:
        check(np.array_equal(got[k], cols[k][order]), f"sharded_time_sort: {k} != np.lexsort")
    ties = int(np.sum(np.diff(cols["timestamp"][order]) == 0))
    print(f"main path 14 sharded_time_sort {N_MESH_SORT} rows, 2 boards, {ties} timestamp ties, "
          f"on {where} ({smi}): = np.lexsort (the input order kept on ties); host wall ms, median "
          f"of 3 (upload, sort, fetch): {statistics.median(t_sort) * 1e3:.1f}; np.lexsort "
          f"{statistics.median(t_lex) * 1e3:.1f}", flush=True)
    raw = get_raw_files(source, data_root=daq, n_channels=2)
    parts = split_parts(RB.build_records_from_raw_files(raw, "vx2730", part_size=None),
                        RECORDS_PART_SIZE)
    t0 = time.perf_counter()
    host = RB.merge_records_parts(parts)
    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    meshed = RB.merge_records_parts(parts, mesh=mesh)
    t_mesh = time.perf_counter() - t0
    check_identical(host.records, meshed.records, "records mesh merge")
    check(np.array_equal(host.wave_pool, meshed.wave_pool), "records mesh merge: wave_pool")
    print(f"main path 14 merge_records_parts of {len(parts)} parts ({len(host.records)} records "
          f"of the {source} files) on {where} ({smi}): = the host merge bit for bit (records "
          f"and wave_pool); wall {t_mesh * 1e3:.1f} ms, host {t_host * 1e3:.1f} ms", flush=True)
    del rec, cols, got, raw, parts, host, meshed

    # ---- the mesh Context ---------------------------------------------------------
    route = {k: 1 for k in ("peaks_scan", "hits_scan", "width_scan")}
    on_mesh = {k: shards for k in route}
    plugins = route_plugin_classes()[:5]
    with tempfile.TemporaryDirectory() as tmp:
        ctxs = {"one": make_route_context(Context, plugins, f"{tmp}/one", dev.type),
                "mesh": make_route_context(Context, plugins, f"{tmp}/mesh", dev.type)}
        ctxs["mesh"].attach_mesh(mesh)
        base = make_batch(n, WAVE_LEN, seed=11)
        walls, memory, tables = {"one": [], "mesh": []}, [], {}
        order = ("one", "mesh", "mesh", "one", "one", "mesh")  # the cold pair, then turns
        for i, side in enumerate(order):
            ctx, rid = ctxs[side], f"m{max(i, 1)}"  # the cold pair reads the same waves
            ctx.inject_data(rid, "st_waveforms", st_waveforms_from_waves(base + np.int16(i // 2)))
            ctx.profiler.reset()
            reset()
            sync()
            t0 = time.perf_counter()
            out = ctx.get_data(rid, list(MEMBERS))
            sync()
            walls[side].append(time.perf_counter() - t0)
            got = counts(on_mesh if side == "mesh" else route, f"{side} Context run {i}")
            if side == "mesh":
                launches.setdefault("context", got)
                memory.append(held())
                phases = {k.split(".", 2)[2]: round(v["total_s"] * 1e3, 1) for k, v in
                          ctx.profiler.stats().items() if k.startswith("fusion.single.")}
            if i < 2:
                tables[side] = out
            ctx.flush_saves()
        for name in MEMBERS:
            check_identical(tables["one"][name], tables["mesh"][name], f"mesh Context {name}")
            check(ctxs["one"].key_for("m1", name) == ctxs["mesh"].key_for("m1", name),
                  f"mesh Context: the lineage key of {name} differs")
        check(max(memory) - min(memory) <= 16 << 20,
              f"mesh Context: memory allocated after each run {memory} B is not flat")
        print(f"main path 14 mesh Context {n}x{WAVE_LEN} on {where} ({smi}): get_data(run, "
              f"{list(MEMBERS)}) = the one-device card Context's tables bit for bit "
              f"({ {m: len(tables['mesh'][m]) for m in MEMBERS} }), lineage keys equal; "
              f"launches {nonzero(launches['context'])}; cold wall one device "
              f"{walls['one'][0] * 1e3:.1f} ms, mesh {walls['mesh'][0] * 1e3:.1f} ms; warm walls "
              f"in turns: mesh {[round(t * 1e3, 1) for t in walls['mesh'][1:]]} ms, one device "
              f"{[round(t * 1e3, 1) for t in walls['one'][1:]]} ms; the last mesh run's "
              f"fusion.single phases ms {phases}; memory allocated after each mesh run "
              f"{sorted(set(memory))} B, flat", flush=True)
        del tables, out
        runs = [f"b{i}" for i in range(N_MESH_BATCH_RUNS)]
        for i, rid in enumerate(runs):
            st = st_waveforms_from_waves(make_batch(N_EVENTS, WAVE_LEN, seed=20 + i))
            for ctx in ctxs.values():
                ctx.inject_data(rid, "st_waveforms", st)
        reset()
        sync()
        t0 = time.perf_counter()
        out = ctxs["mesh"].get_data_batched(runs, list(MEMBERS))
        sync()
        t_b = time.perf_counter() - t0
        launches["batched"] = counts(on_mesh, "batched on the mesh")
        for rid in runs:
            ref = ctxs["one"].get_data(rid, list(MEMBERS))
            for name in MEMBERS:
                check_identical(ref[name], out[rid][name], f"batched mesh {rid}/{name}")
        print(f"main path 14 get_data_batched over {N_MESH_BATCH_RUNS} runs of {N_EVENTS}x"
              f"{WAVE_LEN} on {where} ({smi}): one program, launches "
              f"{nonzero(launches['batched'])}; every table = per-run get_data on the one-device "
              f"card Context bit for bit; wall {t_b * 1e3:.1f} ms", flush=True)
        for ctx in ctxs.values():
            ctx.flush_saves()
        del ctxs, out, base

    # ---- a stream on the mesh ------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        plain = ingest_context(Context, get_profile("streaming"), daq, f"{tmp}/s", dev.type)
        plain.set_config({"signal_peaks_stream": {"streaming_config": {
            "executor_type": "device"}}})
        run = link_run(daq, source, "mesh_stream")
        st = plain.get_data(run, "st_waveforms")
        rows = len(st)
        halo = {"required_halo_left_ns": float(WAVE_LEN * int(C._col(st, "dt")[0]))}
        del st
        plain.get_data(run, "filtered_waveforms")
        meshed = plain.clone().attach_mesh(mesh)
        n_chunks, sp_chunks = -(-rows // STREAM_CHUNK), -(-rows // SIGNAL_PEAKS_CHUNK)
        streams, stream_walls = {}, {}
        for tag, ctx in (("one", plain), ("mesh", meshed)):
            sc = get_streaming_context(ctx)
            reset()
            t0 = time.perf_counter()
            streams[tag, "hit"] = list(sc.get_stream(run, "hit", executor_type="device", **halo))
            sync()
            stream_walls[tag, "hit"] = time.perf_counter() - t0
            got = counts({"peaks_scan": n_chunks}, f"{tag} hit stream")
            reset()
            t0 = time.perf_counter()
            streams[tag, "sp"] = list(ctx.get_data(run, "signal_peaks_stream"))
            sync()
            stream_walls[tag, "sp"] = time.perf_counter() - t0
            got_sp = counts({"peaks_scan": sp_chunks}, f"{tag} signal_peaks_stream")
            if tag == "mesh":
                launches["stream_hit"], launches["signal_peaks_stream"] = got, got_sp
        check_chunks(streams["one", "hit"], streams["mesh", "hit"], "mesh hit stream")
        check_chunks(streams["one", "sp"], streams["mesh", "sp"], "mesh signal_peaks_stream")
        sc = get_streaming_context(meshed)
        t0 = time.perf_counter()
        merged = sc.merge_stream(streams["mesh", "hit"], backend="device", mesh=mesh)
        t_merge = time.perf_counter() - t0
        check_identical(sc.merge_stream(streams["mesh", "hit"], backend="host"), merged,
                        "merge_stream(backend='device')")
        print(f"main path 14 streams of the {source} files ({rows} waveforms) on {where} ({smi}):"
              f" hit ({n_chunks} chunks of {STREAM_CHUNK}, K2 x{n_chunks}) and "
              f"signal_peaks_stream ({sp_chunks} chunks, executor_type 'device', K2 "
              f"x{sp_chunks}) = without the mesh chunk for chunk; merge_stream(backend='device')"
              f" of the hit stream ({len(merged)} rows) = the host merge bit for bit in "
              f"{t_merge * 1e3:.1f} ms; walls ms one device / mesh: hit "
              f"{stream_walls['one', 'hit'] * 1e3:.1f} / {stream_walls['mesh', 'hit'] * 1e3:.1f}, "
              f"signal_peaks_stream {stream_walls['one', 'sp'] * 1e3:.1f} / "
              f"{stream_walls['mesh', 'sp'] * 1e3:.1f}", flush=True)
        plain.flush_saves()
        meshed.flush_saves()
        del streams, merged
    print(f"main path 14 phase 5o: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


EXAMPLES = ("records_pipeline_example", "records_view_example", "batched_multirun_demo",
            "streaming_demo", "s1_s2_pipeline_demo", "waveform_width_example",
            "signal_processing_example", "dual_baseline_example", "config_management_example",
            "list_plugin_configs_example", "progress_tracking_demo", "preview_execution_demo",
            "doc_generator_demo", "verify_lineage_demo", "preview_quickstart",
            "multichip_demo", "tutorial_advanced")
EXAMPLE_WORKERS = 8  # example processes at once, one a core of the card's host
# (each starts python, torch and a CUDA context)


FUZZ_TRIALS, FUZZ_SEED = 14, 99  # the chain fuzz's defaults (256 events a trial)


def tools_phase(kernels: dict) -> dict:
    """Slice 16, the port's tools on the card: the random-config chain fuzz
    (scripts/fuzz_chain_configs_torch.py: K1 and K7 against the plain
    full_chain_step on FUZZ_TRIALS configs of 256 events, ints exact, f32
    within ATOL / RTOL), with every kernel count set to 0 just before it,
    then the install check (scripts/verify_install_torch.py) on the card.
    Returns the fuzz's launches by kernel."""
    import contextlib
    import io

    sys.path.insert(0, str(ROOT / "scripts"))
    import fuzz_chain_configs_torch as fuzz
    import verify_install_torch as verify

    t0 = time.perf_counter()
    for fn in kernels.values():
        fn.launches = 0
    results, log = [], io.StringIO()
    with contextlib.redirect_stdout(log):
        rc = fuzz.main(["--device", "cuda", "--trials", str(FUZZ_TRIALS),
                        "--seed", str(FUZZ_SEED)], results)
    torch.cuda.synchronize()
    got = {name: fn.launches for name, fn in kernels.items()}
    fuzz_s = time.perf_counter() - t0
    check(rc == 0 and len(results) == FUZZ_TRIALS
          and all(r["status"] == fuzz.OK for r in results),
          f"chain fuzz: exit {rc}, PORT MISMATCH:\n{log.getvalue()[-3000:]}")
    check(got["chain_scan"] == got["chain_tile"] == FUZZ_TRIALS
          and not any(v for k, v in got.items() if k not in ("chain_scan", "chain_tile")),
          f"chain fuzz launches {got}, expected chain_scan and chain_tile "
          f"{FUZZ_TRIALS} times each")
    worst = max(r["worst"] for r in results)
    t1 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc = verify.main(["--device", "cuda"])
    verify_s = time.perf_counter() - t1
    text = log.getvalue()
    check(rc == 0 and f"OK ({len(verify.CHECKS)} of {len(verify.CHECKS)} steps passed" in text,
          f"verify_install_torch --device cuda: exit {rc}\n{text[-3000:]}")
    lengths = sorted({r["L"] for r in results})
    print(f"tools: chain fuzz {FUZZ_TRIALS} trials x 256 events (seed {FUZZ_SEED}, L in "
          f"{lengths}): K1 and K7 = full_chain_step on every trial (max |f32 diff| "
          f"{worst:.3g}), launches {got}, {fuzz_s:.2f} s; verify_install_torch --device cuda: "
          f"{len(verify.CHECKS)} of {len(verify.CHECKS)} steps passed in {verify_s:.2f} s; "
          f"phase {time.perf_counter() - t0:.2f} s", flush=True)
    return got


def examples_phase() -> None:
    """The port's examples as a user runs them (on the card by default):
    the records examples, the batched multi-run and streaming demos, the
    eleven of slice 13 and the two of slice 14, EXAMPLE_WORKERS processes at
    a time. Each must exit 0 and say ``device: cuda``."""
    from concurrent.futures import ThreadPoolExecutor

    def run(name: str):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", f"waveformanalysis_tpu_torch.examples.{name}"],
                              capture_output=True, text=True, timeout=600, cwd=ROOT)
        return proc, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(EXAMPLE_WORKERS) as pool:
        done = list(pool.map(run, EXAMPLES))
    for name, (proc, wall) in zip(EXAMPLES, done):
        check(proc.returncode == 0, f"{name} failed: {proc.stderr.strip()[-3000:]}")
        check("device: cuda" in proc.stdout, f"{name} did not run on the card")
        last = proc.stdout.strip().splitlines()[-1]
        print(f"example (python -m waveformanalysis_tpu_torch.examples.{name}): exit 0 on the "
              f"card in {wall:.1f} s; {last[:80]}", flush=True)
    print(f"examples: {len(EXAMPLES)} in {time.perf_counter() - t0:.1f} s, "
          f"{EXAMPLE_WORKERS} at a time", flush=True)


def check_identical(ref, out, tag: str) -> None:
    """Two tables bit for bit: Table fields, or DataFrame columns (per-event
    array cells one by one), with their dtypes; NaN where NaN."""
    import pandas as pd

    def same(a, b) -> bool:
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and np.array_equal(a, b, equal_nan=a.dtype.kind == "f")

    if isinstance(ref, pd.DataFrame):
        check(isinstance(out, pd.DataFrame) and list(out.columns) == list(ref.columns)
              and list(out.dtypes) == list(ref.dtypes) and len(out) == len(ref),
              f"{tag}: columns, dtypes or length differ")
        for col in ref.columns:
            if ref[col].dtype == object and len(ref):
                # per-event array cells: their lengths, their dtypes, and
                # the values of all cells at once
                cells = [[np.asarray(c) for c in side] for side in (ref[col], out[col])]
                ok = ([c.size for c in cells[0]] == [c.size for c in cells[1]]
                      and {c.dtype for c in cells[0]} == {c.dtype for c in cells[1]}
                      and same(*(np.concatenate([c.ravel() for c in side])
                                 for side in cells)))
            else:
                ok = same(ref[col].to_numpy(), out[col].to_numpy())
            check(ok, f"{tag}.{col}: not bit-identical")
        return
    check(ref.field_names == out.field_names and len(ref) == len(out),
          f"{tag}: fields {out.field_names} x {len(out)} != {ref.field_names} x {len(ref)}")
    for f in ref.field_names:
        check(same(ref[f], out[f]), f"{tag}.{f}: not bit-identical")


BATCH_PHASE_KEYS = ("fusion.wave_chain.compute_many", "fusion.batched.prep_run",
                    "fusion.batched.upload", "fusion.batched.device_program",
                    "fusion.batched.fetch", "fusion.batched.finalize",
                    "fusion.wave_chain.compute", "fusion.single.load", "fusion.single.upload",
                    "fusion.single.device_program", "fusion.single.fetch",
                    "fusion.single.finalize", "context.save_cache",
                    "context.release_device_columns")


def timed_turns(ctx, order, call) -> dict:
    """``call(i, kind)`` for each kind ("B" batched or "P" per-run) of
    ``order`` on ``ctx``, each timed on the host clock up to a device
    synchronize, then flush_saves() timed apart; per kind the walls, the
    profiler phases (s), the flush times, the memory allocated after each
    call and the peak above its start. Returns {kind: {...}}."""
    out = {k: {"walls": [], "phases": [], "flushes": [], "peaks": []} for k in set(order)}
    held = []
    for i, kind in enumerate(order):
        ctx.profiler.reset()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        call(i, kind)
        torch.cuda.synchronize()
        rec = out[kind]
        rec["walls"].append(time.perf_counter() - t0)
        rec["peaks"].append(torch.cuda.max_memory_allocated() - before)
        rec["phases"].append({k: v["total_s"] for k, v in ctx.profiler.stats().items()})
        t0 = time.perf_counter()
        ctx.flush_saves()
        rec["flushes"].append(time.perf_counter() - t0)
        held.append(torch.cuda.memory_allocated())
    check(max(held) - min(held) <= 16 << 20,
          f"memory allocated after each call {held} B is not flat")
    out["held"] = held
    return out


def turns_line(rec, n_wf: int) -> str:
    """Median wall (and waveforms/s), the walls, the median phases in ms,
    the median flush and the largest peak of one kind's calls."""
    idx = list(range(len(rec["walls"])))
    med = statistics.median(rec["walls"][i] for i in idx)
    phases = {k.split(".", 1)[1]: round(statistics.median(
        rec["phases"][i].get(k, 0.0) for i in idx) * 1e3, 1)
        for k in BATCH_PHASE_KEYS if any(k in rec["phases"][i] for i in idx)}
    return (f"median of {len(idx)} {med * 1e3:.1f} ms = {n_wf / med:.0f} waveforms/s (calls "
            f"{[round(rec['walls'][i] * 1e3, 1) for i in idx]} ms); phases ms {phases}; "
            f"flush_saves median {statistics.median(rec['flushes'][i] for i in idx) * 1e3:.1f} "
            f"ms; peak above the call's start {max(rec['peaks']) / 1e9:.3f} GB")


def batched_injected_phase(dev, smi: str, kernels: dict, plugins) -> dict:
    """Slice 10's main path on injected waves: slice 2's Context (the five
    cone plugins, config 7) and request over N_BATCH_RUNS runs of
    N_EVENTS x 256 of bench.py's waves, each run its own batch, through
    ``get_data_batched``. The
    first call launches K2, K3 and K4 exactly once and runs
    ``fusion.wave_chain.compute_many``; every run's tables equal per-run
    ``get_data`` on a second card Context bit for bit. Then the batched
    call against the same 16 runs through per-run ``get_data``, in turns
    (cold batched and per-run, then P B B P P B), fresh run ids every call,
    with the memory allocated after each call (flat) and each call's peak;
    one warm batched call under torch.profiler; and two runs of
    N_BATCH_CPU through get_data_batched on the card against the port's CPU
    Context. Returns the first call's launch counts."""
    from bench import make_batch
    from waveformanalysis_tpu_torch.context.context import Context
    from waveformanalysis_tpu_torch.testing.fixtures import st_waveforms_from_waves

    request = ["s1_s2", "hit_threshold"]
    bases = [make_batch(N_EVENTS, WAVE_LEN, seed=600 + i) for i in range(N_BATCH_RUNS)]
    n_wf = N_BATCH_RUNS * N_EVENTS

    def inject(ctx, call: int) -> list:
        """Fresh run ids; every call holds the same 16 batches (rotated
        over the ids), so every call does the same work."""
        rids = [f"c{call}r{i}" for i in range(N_BATCH_RUNS)]
        for i, rid in enumerate(rids):
            waves = bases[(i + call) % N_BATCH_RUNS]
            ctx.inject_data(rid, "st_waveforms", st_waveforms_from_waves(waves))
        return rids

    def forget(ctx, rids) -> None:  # keep the host memory of earlier calls bounded
        for key in [k for k in ctx._results if k[0] in rids]:
            del ctx._results[key]

    with tempfile.TemporaryDirectory() as tmp:
        ctx = make_route_context(Context, plugins, f"{tmp}/batched", "cuda")
        ref = make_route_context(Context, plugins, f"{tmp}/per_run", "cuda")
        rids = inject(ctx, 0)
        inject(ref, 0)
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        got = ctx.get_data_batched(rids, request)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in kernels.items()}
        want = {k: int(k in ("peaks_scan", "hits_scan", "width_scan")) for k in kernels}
        check(launches == want, f"batched injected: launches {launches}, expected {want}")
        check(ctx.profiler.stats()["fusion.wave_chain.compute_many"]["count"] == 1,
              "batched injected: compute_many did not run once")
        on_card = [key for key, t in ctx._results.items() if hasattr(t, "columns") and any(
            isinstance(v, torch.Tensor) and v.is_cuda for v in t.columns.values())]
        check(not on_card, f"batched injected: cached tables with columns on the card {on_card}")
        t0 = time.perf_counter()
        for rid in rids:
            ref.get_data(rid, request)
        torch.cuda.synchronize()
        cold_per_run = time.perf_counter() - t0
        sizes = {m: 0 for m in MEMBERS}
        for rid in rids:
            for m in MEMBERS:
                table = ctx.get_data(rid, m)
                check_identical(ref.get_data(rid, m), table, f"batched {rid}.{m}")
                sizes[m] += len(table)
            for m in request:
                check_identical(ref.get_data(rid, m), got[rid][m], f"batched result {rid}.{m}")
        ctx.flush_saves()
        ref.flush_saves()
        forget(ctx, rids)
        forget(ref, rids)
        del got, ref
        print(f"main path 10 batched: get_data_batched({N_BATCH_RUNS} runs x {N_EVENTS}x"
              f"{WAVE_LEN} = {n_wf} waveforms, {request}) launches {launches} (one program); "
              f"tables {sizes} in all; every run's tables = per-run get_data on a second card "
              f"Context bit for bit; cold {cold:.3f} s (the {N_BATCH_RUNS} per-run calls "
              f"cold {cold_per_run:.3f} s)", flush=True)

        order = ("P", "B", "B", "P", "P", "B")
        seen = []

        def call(i, kind):
            rids = inject(ctx, i + 1)
            if kind == "B":
                ctx.get_data_batched(rids, request)
            else:
                for rid in rids:
                    ctx.get_data(rid, request)
            seen.append(rids)

        rec = timed_turns(ctx, order, call)
        for rids in seen:
            forget(ctx, rids)
        print(f"route batched {N_BATCH_RUNS}x{N_EVENTS}x{WAVE_LEN} ({smi}), in turns "
              f"{''.join(order)}: batched get_data_batched {turns_line(rec['B'], n_wf)}; "
              f"per-run get_data x{N_BATCH_RUNS} {turns_line(rec['P'], n_wf)}; memory "
              f"allocated after each call {rec['held']} B", flush=True)
        rids = inject(ctx, len(order) + 1)
        profile_call(ctx, lambda: ctx.get_data_batched(rids, request),
                     f"batched {N_BATCH_RUNS}x{N_EVENTS}x{WAVE_LEN}", smi)
        forget(ctx, rids)
        del ctx

        # two runs through the batched program on the card and on the CPU
        small = {f"s{i}": st_waveforms_from_waves(make_batch(N_BATCH_CPU, WAVE_LEN, seed=650 + i))
                 for i in range(2)}
        out = {}
        for device in ("cuda", "cpu"):
            c = make_route_context(Context, plugins, f"{tmp}/small_{device}", device)
            for rid, st in small.items():
                c.inject_data(rid, "st_waveforms", st)
            c.get_data_batched(list(small), request)
            out[device] = {(rid, m): c.get_data(rid, m) for rid in small for m in MEMBERS}
            c.flush_saves()
        err, where = max(compare_tables(out["cpu"][k], out["cuda"][k], f"{k[0]}.{k[1]}")
                         for k in out["cpu"])
        print(f"main path 10 batched at 2x{N_BATCH_CPU}x{WAVE_LEN}: every member table = the "
              f"CPU Context's batched tables (max |f32 diff| {err:.3g}, {where})", flush=True)
    return launches


def batched_files_phase(dev, kernels: dict, daq: str, source: str) -> dict:
    """Slice 10 on the ingest route: N_BATCH_FILE_RUNS fresh run names
    linked to the ingest phase's VX2730 files (``source``, N_INGEST
    waveforms each) through ``get_data_batched(runs, INGEST_REQUEST)`` on
    the default profile. The first call runs compute_many once: K3 once
    for the group, K2 once a run (``hit`` reads the SG-filtered waves, a
    standalone member as in the per-run route), nothing else; every table
    of the request equals per-run ``get_data`` on a second Context bit for
    bit; the cold pair is timed. Then
    ``BatchProcessor(ctx, executor_type="device", on_error="raise")``
    computes df_events on fresh names through compute_many, and the thread
    executor with 2 workers counts every K2 launch of s1_s2 on two runs at
    once and gives the same df_events. Returns the first call's launch
    counts."""
    from waveformanalysis_tpu_torch.context.context import Context
    from waveformanalysis_tpu_torch.data.batch_processor import BatchProcessor
    from waveformanalysis_tpu_torch.plugins.plugin_sets import get_profile

    def names(tag: str, k: int = N_BATCH_FILE_RUNS) -> list:
        return [link_run(daq, source, f"bf_{tag}_{i}") for i in range(k)]

    with tempfile.TemporaryDirectory() as tmp:
        ctx = ingest_context(Context, get_profile("cuda"), daq, f"{tmp}/batched", dev.type)
        ref = ingest_context(Context, get_profile("cuda"), daq, f"{tmp}/per_run", dev.type)
        rids = names("c0")
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        got = ctx.get_data_batched(rids, INGEST_REQUEST)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in kernels.items()}
        want = {k: {"hits_scan": 1, "peaks_scan": N_BATCH_FILE_RUNS}.get(k, 0) for k in kernels}
        check(launches == want, f"batched files: launches {launches}, expected {want}")
        check(ctx.profiler.stats()["fusion.wave_chain.compute_many"]["count"] == 1,
              "batched files: compute_many did not run once")
        t0 = time.perf_counter()
        for rid in rids:
            ref.get_data(rid, INGEST_REQUEST)
        torch.cuda.synchronize()
        cold_per_run = time.perf_counter() - t0
        for rid in rids:
            for name in INGEST_COMPARED:
                check_identical(ref.get_data(rid, name), ctx.get_data(rid, name),
                                f"batched files {rid}.{name}")
            for name in INGEST_REQUEST:
                check_identical(ref.get_data(rid, name), got[rid][name],
                                f"batched files result {rid}.{name}")
        ctx.flush_saves()
        ref.flush_saves()
        del got, ref
        print(f"main path 10 batched files: get_data_batched({N_BATCH_FILE_RUNS} runs x "
              f"{N_INGEST}x{WAVE_LEN} from VX2730 files, {INGEST_REQUEST}) launches {launches}; "
              f"every table of {list(INGEST_COMPARED)} = per-run get_data on a second card "
              f"Context bit for bit; cold {cold:.3f} s (the per-run calls cold "
              f"{cold_per_run:.3f} s)", flush=True)

        rids = names("bp")
        ctx.profiler.reset()
        t0 = time.perf_counter()
        res = BatchProcessor(ctx, executor_type="device", on_error="raise").process_runs(
            rids, "df_events")
        t_device = time.perf_counter() - t0
        check(sorted(res.succeeded) == sorted(rids) and not res.failed,
              f"BatchProcessor device executor: {res.summary()}")
        check(ctx.profiler.stats().get("fusion.wave_chain.compute_many", {}).get("count") == 1,
              "BatchProcessor device executor: compute_many did not run once")
        # the thread executor: each worker a clone of ctx. s1_s2 launches K2
        # once a run (the standalone hit), from two threads at once; then
        # df_events of the same runs
        thread_rids = names("th", 2)
        bp_t = BatchProcessor(ctx, executor_type="thread", max_workers=2, on_error="raise")
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        bp_t.process_runs(thread_rids, "s1_s2")
        torch.cuda.synchronize()
        t_thread = time.perf_counter() - t0
        got_t = {name: fn.launches for name, fn in kernels.items()}
        want_t = {k: {"peaks_scan": 2}.get(k, 0) for k in kernels}
        check(got_t == want_t, f"thread executor: launches {got_t}, expected {want_t} "
              f"(a lost count?)")
        res_t = bp_t.process_runs(thread_rids, "df_events")
        for rid in thread_rids:  # the same files: the same table
            check_identical(res.get(rids[0]).data, res_t.get(rid).data,
                            f"thread executor {rid}.df_events")
        ctx.flush_saves()
        print(f"main path 10 BatchProcessor on the files: executor_type='device' "
              f"(on_error='raise') df_events of {N_BATCH_FILE_RUNS} fresh runs through "
              f"compute_many in {t_device:.3f} s; executor_type='thread' with 2 workers: s1_s2 "
              f"of 2 runs in {t_thread:.3f} s, launches {got_t} (none lost), then their "
              f"df_events = the device executor's bit for bit "
              f"({len(res_t.get(thread_rids[0]).data)} rows)", flush=True)
    return launches


def batched_kernel_cases(dev, make_batch, csc, wsc, find_peaks_batch,
                         threshold_hits_batch) -> dict:
    """K2, K3 and K4 on a batched group's matrix, each against its plain
    version on the same card tensors: BATCH_RUNS of bench.py's waves built
    by the batched dispatch's own ``_batch_waves`` (narrower rows padded
    with zeros, zero-length padding rows up to a multiple of BATCH_BUCKET),
    the signal and inputs as the hit / hit_threshold stages form them from
    the group's columns (padding: sign 1, baseline 0, threshold 0); K2 and
    K3 at K = 8, 16 and 32, K4 on K2's K = 32 slots. The padding rows must
    hold no peak and no run. Returns {kernel: [(case line, max |f32
    diff|)]}."""
    from waveformanalysis_tpu_torch.context.fusion import WaveChainFusion

    total = sum(n for n, _ in BATCH_RUNS)
    padded = -(-total // BATCH_BUCKET) * BATCH_BUCKET
    L = max(length for _, length in BATCH_RUNS)
    preps = [{"waves": make_batch(n, length, seed=40 + i), "n": n}
             for i, (n, length) in enumerate(BATCH_RUNS)]
    waves = WaveChainFusion._batch_waves(preps, L, padded, dev)
    lengths = np.zeros(padded, np.int32)
    lengths[:total] = np.repeat([length for _, length in BATCH_RUNS],
                                [n for n, _ in BATCH_RUNS])
    vl = torch.from_numpy(lengths).to(dev)
    bl = torch.zeros(padded, device=dev)
    bl[:total] = 1000.0
    thr = torch.zeros(padded, device=dev)
    thr[:total] = 10.0
    sig = waves.float() - bl[:, None]
    check(waves.dtype == torch.int16 and tuple(waves.shape) == (padded, L)
          and not bool(waves[total:].any()), "batched matrix: padding rows not zero")
    shape = f"{padded}x{L} ({'+'.join(f'{n}x{length}' for n, length in BATCH_RUNS)}, " \
            f"{padded - total} zero-length rows)"
    peak_fields = ("peak_value", "prominence", "left_ips", "right_ips", "widths",
                   "left_bases", "right_bases")
    hit_fields = ("position", "height", "integral", "seg_start", "seg_end",
                  "run_start", "run_end")
    out_cases = {"peaks_scan": [], "hits_scan": [], "width_scan": []}
    pos32 = None
    for K in (8, 16, 32):
        kw = dict(height=80.0, prominence=50.0, width=2.0, distance=2, max_peaks=K)
        before = csc.find_peaks_scan.launches
        out = csc.find_peaks_scan(sig, valid_length=vl, **kw)
        torch.cuda.synchronize()
        check(csc.find_peaks_scan.launches == before + 1, f"peaks batched K={K}: not launched")
        ref = find_peaks_batch(sig, valid_length=vl, **kw)
        err = compare(ref, out, f"peaks batched K={K}", ref["valid"].cpu().numpy(), peak_fields)
        check(not bool(out["n_candidates"][total:].any()) and not bool(out["valid"][total:].any()),
              f"peaks batched K={K}: a padding row holds a peak")
        out_cases["peaks_scan"].append(
            (f"K={K} on {shape} ({err:.3g}; {int(ref['valid'].sum())} peaks, "
             f"{int((ref['n_candidates'] > K).sum())} events overflow)", err))
        if K == 32:
            pos32 = out["position"]
        kw = dict(max_hits=K, left_extension=2, right_extension=2)
        before = csc.threshold_hits_scan.launches
        out = csc.threshold_hits_scan(sig, thr, vl, **kw)
        torch.cuda.synchronize()
        check(csc.threshold_hits_scan.launches == before + 1, f"hits batched K={K}: not launched")
        ref = threshold_hits_batch(sig, thr, vl, **kw)
        err = compare(ref, out, f"hits batched K={K}", ref["valid"].cpu().numpy(), hit_fields)
        check(not bool(out["n_runs"][total:].any()) and not bool(out["valid"][total:].any()),
              f"hits batched K={K}: a padding row holds a run")
        out_cases["hits_scan"].append(
            (f"K={K} on {shape} ({err:.3g}; {int(ref['valid'].sum())} runs, "
             f"{int((ref['n_runs'] > K).sum())} events overflow)", err))
    before = wsc.width_crossings_scan.launches
    out = wsc.width_crossings_scan(waves, bl, pos32, 0.1, 0.9, 0.9, 0.1, True)
    torch.cuda.synchronize()
    check(wsc.width_crossings_scan.launches == before + 1, "width batched: not launched")
    ref = wsc.width_crossings_plain(waves, bl, pos32, 0.1, 0.9, 0.9, 0.1, True)
    err = compare(ref, out, "width batched")
    out_cases["width_scan"].append(
        (f"K2's K=32 slots on {shape} int16 ({err:.3g}; {int((pos32 >= 0).sum())} "
         f"occupied slots)", err))
    return out_cases


def main() -> None:
    # ---- phase 1: device ---------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    sys.path.insert(0, str(ROOT))
    from bench import make_batch
    from waveformanalysis_tpu_torch.context.context import Context
    from waveformanalysis_tpu_torch.dtypes.table import Table
    from waveformanalysis_tpu_torch.kernels._build import build_all
    from waveformanalysis_tpu_torch.models.full_chain import (
        ChainConfig,
        batch_from_numpy,
        full_chain_step,
    )
    import waveformanalysis_tpu_torch as wa
    from waveformanalysis_tpu_torch.examples import fused_chain_demo
    from waveformanalysis_tpu_torch.ops import chain_scan_cuda as csc
    from waveformanalysis_tpu_torch.ops import chain_tile_cuda as ctc
    from waveformanalysis_tpu_torch.ops import filter_cuda as flc
    from waveformanalysis_tpu_torch.ops import filtering as flt
    from waveformanalysis_tpu_torch.ops import width_scan_cuda as wsc
    from waveformanalysis_tpu_torch.ops.hits import threshold_hits_batch
    from waveformanalysis_tpu_torch.ops.peaks import find_peaks_batch
    from waveformanalysis_tpu_torch.testing.fixtures import st_waveforms_from_waves

    filter_plugins = route_plugin_classes()
    route_plugins = filter_plugins[:5]
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
    built = build_all(["chain_scan", "chain_tile", "peaks_scan", "hits_scan", "width_scan",
                       "sosfilt"])
    for name, b in built.items():
        regs = "; ".join(
            f"{kernel_tag(p['function'])}: {p.get('registers')} regs, "
            f"{p.get('spill_stores')}/{p.get('spill_loads')} B spill st/ld, "
            f"{p.get('static_smem', 0)} B static smem"
            for p in b.ptxas)
        print(f"build {name}: {b.path.name} in {b.seconds:.1f} s; {regs}", flush=True)
    print(f"build wall {time.perf_counter() - t0:.1f} s", flush=True)
    # K7's row choice counts the warps an SM holds with TILE_REGISTERS a thread
    tile_regs = {p.get("registers") for p in built["chain_tile"].ptxas
                 if "chain_tile_kernel" in p["function"]}
    check(tile_regs == {ctc.TILE_REGISTERS}, f"chain_tile_kernel uses {tile_regs} registers a "
          f"thread; ops/chain_tile_cuda.py::TILE_REGISTERS says {ctc.TILE_REGISTERS}")

    stamp("phase 2 (build)")

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
    max_err = {"chain_scan": 0.0, "chain_tile": 0.0, "peaks_scan": 0.0, "hits_scan": 0.0,
               "width_scan": 0.0, "sosfiltfilt": 0.0, "sosfilt": 0.0}
    # L = 250: rows that are not 16-byte aligned and a ragged last block of
    # the tile kernel (n = 65,529 is no multiple of its 8 events per block)
    ragged250_np = ragged_batch(n - 7, 250, seed=4)

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
        ("dense_noise_k32_d2", ChainConfig(use_derivative=False, peak_height=10.0,
                                           peak_prominence=2.0, peak_width=0.5,
                                           peak_distance=2, max_peaks=32, max_hits=32,
                                           hit_threshold=5.0), dense_np),
        ("ragged_n_minus_7_L250", ChainConfig(use_derivative=False, peak_height=60.0,
                                              peak_prominence=30.0, peak_width=1.5),
         ragged250_np),
        # the derivative signal at K = 32 on unaligned rows (element copies)
        ("derivative_k32_d3_L250", ChainConfig(use_derivative=True, peak_height=20.0,
                                               peak_prominence=5.0, peak_width=1.0,
                                               peak_distance=3, max_peaks=32, max_hits=32),
         ragged250_np),
        # rows too long for K7's float32 signal row (it keeps the int16 row)
        (f"long_rows_L{CHAIN_LONG_ROW}", ChainConfig(use_derivative=False, peak_height=60.0,
                                                     peak_prominence=30.0, peak_width=1.5,
                                                     peak_distance=2, max_peaks=32,
                                                     max_hits=32),
         ragged_batch(515, CHAIN_LONG_ROW, seed=6)),
    ]
    # one line per kernel: every case's tag, shape and what it found
    parity = {name: [] for name in max_err}
    for tag, cfg, arrays in chain_cases:
        batch = batch_from_numpy(*arrays, device=dev)
        ref = full_chain_step(*batch, cfg)
        outs = {}
        for name, fn in (("chain_scan", csc.chain_scan_cuda), ("chain_tile", ctc.chain_tile_cuda)):
            before = fn.launches
            outs[name] = fn(*batch, cfg)
            torch.cuda.synchronize()
            check(fn.launches == before + 1, f"{name} {tag}: kernel not launched")
            err = compare(ref, outs[name], f"{name} {tag}")
            max_err[name] = max(max_err[name], err)
            parity[name].append(
                f"{tag} {batch[0].shape[0]}x{batch[0].shape[1]} ({err:.3g}; peak overflow "
                f"{int(outs[name]['n_peak_overflow'])}, labels "
                f"{np.bincount(outs[name]['label'].cpu().numpy(), minlength=3).tolist()})")
        ints = [k for k, v in ref.items() if not v.dtype.is_floating_point]
        check(all(torch.equal(outs["chain_tile"][k], outs["chain_scan"][k]) for k in ints),
              f"chain_tile {tag}: integer outputs differ from chain_scan's")
    print(f"parity chain_scan: {len(chain_cases)} cases = full_chain_step (max |f32 diff| in "
          f"brackets): {'; '.join(parity['chain_scan'])}", flush=True)
    print(f"parity chain_tile: the same {len(chain_cases)} cases = full_chain_step (max |f32 "
          f"diff| {max_err['chain_tile']:.3g}), integer outputs {ints} = chain_scan's", flush=True)
    del outs, ref

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
    # K = 32 as the routes run it; 65,529 x 250 (element row copies, a
    # ragged last block), the derivative signal's 255 columns, and rows of
    # 65,536 samples, read from global memory (the long-row mode)
    w250, el250, bl250, pol250 = (torch.from_numpy(a).to(dev) for a in ragged250_np)
    s250 = torch.where(pol250 > 0, 1.0, -1.0)[:, None] * (w250.float() - bl250[:, None])
    # four rows of 256 of bench.py's events each: many pulses, overflowing
    # slot tables, walks across the row; ragged valid lengths
    wl = w_main[: 4 * LONG_ROW // L].reshape(4, LONG_ROW)
    ell = torch.tensor([LONG_ROW, 40_000, 12_345, LONG_ROW - 3], dtype=torch.int32, device=dev)
    bll = torch.full((4,), 1000.0, device=dev)
    s_long = wl.float() - 1000.0
    check(not csc.row_layout(LONG_ROW, 4, s_long.data_ptr(), csc.PEAK_SLOT_BYTES).staged,
          "the long-row case does not reach the long-row mode")
    dense_sig = torch.from_numpy(dense_np[0]).to(dev).float() - 1000.0
    k32 = dict(height=60.0, prominence=30.0, width=1.5, distance=2, max_peaks=32)
    peak_cases = [
        ("bench_config7_k8", sig_main, vl_main,
         dict(height=80.0, prominence=50.0, width=2.0, distance=2, max_peaks=8)),
        ("ragged_d3_k16", sig_rag, rel,
         dict(height=60.0, prominence=30.0, width=1.5, distance=3, max_peaks=16)),
        ("derivative_k8", sig_der, (rel - 1).clamp(min=0),
         dict(height=20.0, prominence=5.0, width=1.0, distance=3, max_peaks=8)),
        ("bench_k32_d2", sig_main, vl_main,
         dict(height=80.0, prominence=50.0, width=2.0, distance=2, max_peaks=32)),
        ("dense_noise_k32_d2", dense_sig, rel,
         dict(height=10.0, prominence=2.0, width=0.5, distance=2, max_peaks=32)),
        ("n_minus_7_L250_k32", s250, el250, k32),
        ("derivative_255_k32", sig_der, (rel - 1).clamp(min=0),
         dict(height=20.0, prominence=5.0, width=1.0, distance=3, max_peaks=32)),
        (f"long_rows_4x{LONG_ROW}_k32", s_long, ell, k32),
    ]
    slots_of = {}
    for tag, sig, vl, kw in peak_cases:
        before = csc.find_peaks_scan.launches
        out = csc.find_peaks_scan(sig, valid_length=vl, **kw)
        torch.cuda.synchronize()
        check(csc.find_peaks_scan.launches == before + 1, f"peaks {tag}: kernel not launched")
        ref = find_peaks_batch(sig, valid_length=vl, **kw)
        err = compare(ref, out, f"peaks {tag}", ref["valid"].cpu().numpy(), peak_fields)
        max_err["peaks_scan"] = max(max_err["peaks_scan"], err)
        slots_of[tag] = out["position"]
        parity["peaks_scan"].append(
            f"{tag} {sig.shape[0]}x{sig.shape[1]} ({err:.3g}; {int(ref['valid'].sum())} peaks, "
            f"{int((ref['n_candidates'] > kw['max_peaks']).sum())} events overflow)")
    print(f"parity peaks_scan: {len(peak_cases)} cases = find_peaks_batch (max |f32 diff| in "
          f"brackets): {'; '.join(parity['peaks_scan'])}", flush=True)

    hit_fields = ("position", "height", "integral", "seg_start", "seg_end",
                  "run_start", "run_end")
    rng = np.random.default_rng(3)
    thr_evt = torch.from_numpy(rng.uniform(20, 60, n).astype(np.float32)).to(dev)
    sig_edge = sig_rag.clone()
    sig_edge[:, -6:] += 400.0  # runs that reach the wave end
    sig_edge[::3, 40:43] += 400.0

    def run_shapes(sig, vl):
        """One kind of event in turn: one run over the whole row; runs that
        straddle the kernel's 32-sample steps; a run still open at the valid
        length; a comb of runs every third sample (more than 40 runs)."""
        out = sig.clone()
        m = out.shape[1]
        t = torch.arange(m, device=dev)
        out[0::4] += 400.0
        out[1::4] += 400.0 * ((t % 32 <= 1) | (t % 32 >= 30)).float()
        out[2::4] += 400.0 * (t[None, :] >= (vl[2::4, None] - 17)).float()
        out[3::4] += 400.0 * (t % 3 == 0).float()
        return out

    sig_shapes = run_shapes(sig_rag, rel)
    s250_shapes = run_shapes(s250, el250)
    s_long_shapes = run_shapes(s_long, ell)
    hit_cases = [
        ("bench_thr10_k32", sig_main, torch.full((n,), 10.0, device=dev), vl_main,
         dict(max_hits=32)),
        ("ragged_per_event_thr_k8", sig_rag, thr_evt, rel,
         dict(max_hits=8, left_extension=2, right_extension=3)),
        ("runs_to_boundary_k2", sig_edge, thr_evt, vl_main,
         dict(max_hits=2, left_extension=1, right_extension=4)),
        ("run_shapes_k1", sig_shapes, thr_evt, rel, dict(max_hits=1)),
        ("run_shapes_k32", sig_shapes, thr_evt, rel, dict(max_hits=32)),
        ("run_shapes_k40_ext0_5", sig_shapes, thr_evt, rel,
         dict(max_hits=40, left_extension=0, right_extension=5)),
        ("run_shapes_n_minus_7_L250_k32", s250_shapes, thr_evt[: n - 7], el250,
         dict(max_hits=32)),
        (f"run_shapes_long_rows_4x{LONG_ROW}_k32", s_long_shapes, bll * 0 + 50.0, ell,
         dict(max_hits=32)),
    ]
    for tag, sig, thr, vl, kw in hit_cases:
        before = csc.threshold_hits_scan.launches
        out = csc.threshold_hits_scan(sig, thr, vl, **kw)
        torch.cuda.synchronize()
        check(csc.threshold_hits_scan.launches == before + 1, f"hits {tag}: kernel not launched")
        ref = threshold_hits_batch(sig, thr, vl, **kw)
        err = compare(ref, out, f"hits {tag}", ref["valid"].cpu().numpy(), hit_fields)
        max_err["hits_scan"] = max(max_err["hits_scan"], err)
        lay = csc.row_layout(sig.shape[1], 4, sig.data_ptr(), csc.HIT_SLOT_BYTES)
        parity["hits_scan"].append(
            f"{tag} {sig.shape[0]}x{sig.shape[1]} ({err:.3g}; {int(ref['valid'].sum())} runs, max "
            f"{int(ref['n_runs'].max())}, {int((ref['n_runs'] > kw['max_hits']).sum())} events "
            f"overflow; staged {lay.staged}, 16-byte {lay.vec})")
    print(f"parity hits_scan: {len(hit_cases)} cases = threshold_hits_batch (max |f32 diff| in "
          f"brackets): {'; '.join(parity['hits_scan'])}", flush=True)
    del sig_shapes, s250_shapes, s_long_shapes

    slots = csc.find_peaks_scan(sig_main, valid_length=vl_main, height=80.0,
                                prominence=50.0, width=2.0, distance=2, max_peaks=32)
    pos_main = slots["position"]
    bl_main = w_main.float()[:, :50].sum(dim=1) / 50
    pos_odd = torch.from_numpy(rng.integers(-3, L + 3, (n, 4)).astype(np.int32)).to(dev)
    width_cases = [
        ("k2_slots_k32_int16", w_main, bl_main, pos_main, True),
        ("k2_slots_k32_f32", w_main.float(), bl_main, pos_main, True),
        ("odd_positions_no_interp", rw, bl_main, pos_odd, False),
        ("n_minus_7_L250_k32_int16", w250, bl250, slots_of["n_minus_7_L250_k32"], True),
        (f"long_rows_4x{LONG_ROW}_k32_f32", wl.float(), bll,
         slots_of[f"long_rows_4x{LONG_ROW}_k32"], True),
        (f"long_rows_4x{LONG_ROW}_k32_int16", wl, bll,
         slots_of[f"long_rows_4x{LONG_ROW}_k32"], True),
    ]
    for tag, w, bl, pos, interp in width_cases:
        before = wsc.width_crossings_scan.launches
        out = wsc.width_crossings_scan(w, bl, pos, 0.1, 0.9, 0.9, 0.1, interp)
        torch.cuda.synchronize()
        check(wsc.width_crossings_scan.launches == before + 1, f"width {tag}: kernel not launched")
        ref = wsc.width_crossings_plain(w, bl, pos, 0.1, 0.9, 0.9, 0.1, interp)
        err = compare(ref, out, f"width {tag}")
        max_err["width_scan"] = max(max_err["width_scan"], err)
        parity["width_scan"].append(f"{tag} {w.shape[0]}x{w.shape[1]} {str(w.dtype)[6:]} "
                                    f"({err:.3g}; {int((pos >= 0).sum())} occupied slots)")
    print(f"parity width_scan: {len(width_cases)} cases = width_crossings_plain (max |f32 diff| "
          f"in brackets): {'; '.join(parity['width_scan'])}", flush=True)
    for name, cases in batched_kernel_cases(dev, make_batch, csc, wsc, find_peaks_batch,
                                            threshold_hits_batch).items():
        max_err[name] = max([max_err[name]] + [err for _, err in cases])
        print(f"parity {name} batched group: {'; '.join(tag for tag, _ in cases)}",
              flush=True)
    del slots, sig_rag, sig_der, sig_edge, slots_of, s250, w250, s_long, wl, dense_sig
    del ragged250_np

    # K5 (zero-phase, one launch) and K6 (one direction, twice in the
    # two-pass mode) against the plain version on the same card tensors:
    # bit-equal. K5 cases: S = 1 to 6 (two chunks of sections at 6), odd n
    # (a ragged last 32-event block), L = 250 and 256, int16 and f32 input,
    # and rows too long for the shared-memory tile (the long-row mode)
    designs = {k: flt.design_butterworth_sos(*v) for k, v in FILTER_DESIGNS.items()}
    x_main = w_main.float()
    long_w = torch.from_numpy(ragged_batch(2_053, FILTER_LONG_ROW, seed=5)[0]).to(dev)
    filter_cases = [
        ("route_b_bench", designs["route_b"], x_main),
        ("config3_ragged", designs["config3"], rw.float()),
        ("order3_bench", designs["order3"], x_main),
        ("config3_offset_15000", designs["config3"], x_main + 15000.0),
        ("route_b_n_minus_7", designs["route_b"], x_main[: n - 7]),
        ("order6_two_chunks", designs["order6"], x_main),
        ("order1_L250_n_minus_7", designs["order1"], x_main[: n - 7, :250].contiguous()),
        ("order6_L250_n_minus_7", designs["order6"], x_main[: n - 7, :250].contiguous()),
        ("route_b_int16", designs["route_b"], w_main),
        (f"route_b_long_rows_{FILTER_LONG_ROW}_int16", designs["route_b"], long_w),
    ]
    for tag, sos, x in filter_cases:
        padlen = flt.sosfiltfilt_padlen(sos)
        lay = flc.filter_layout(x.shape[1], padlen)
        before = flc.sosfiltfilt_cuda.launches
        out = flc.sosfiltfilt_cuda(x, sos)
        torch.cuda.synchronize()
        check(flc.sosfiltfilt_cuda.launches == before + 1, f"sosfiltfilt {tag}: kernel not launched")
        err = filter_equal(flt.sosfiltfilt_plain(x, sos), out, f"sosfiltfilt {tag}")
        max_err["sosfiltfilt"] = max(max_err["sosfiltfilt"], err)
        parity["sosfiltfilt"].append(f"{tag} {x.shape[0]}x{x.shape[1]} {str(x.dtype)[6:]} "
                                     f"S={sos.shape[0]} padlen {padlen} "
                                     f"{'tile' if lay.staged else 'long rows'}")
    print(f"parity sosfiltfilt: {len(filter_cases)} cases bit-equal to sosfiltfilt_plain: "
          f"{'; '.join(parity['sosfiltfilt'])}", flush=True)
    # K6 (one direction, forward and in reverse) against its plain version on
    # the same event-major rows and state, bit-equal: route B's reflected
    # rows at n and n - 7 events, rows of 251 samples (no multiple of the
    # 128-sample chunk), S = 1, 3, 4 and 6, and 2,053 x 4,096 rows
    rng6 = np.random.default_rng(66)

    def reflected(sos, x):
        xc = x - flt.condition(x, sos)[0]
        return flt.reflect(xc, flt.sosfiltfilt_padlen(sos))

    long6 = torch.from_numpy(ragged_batch(2_053, FILTER_LONG_ROW, seed=6)[0]).to(dev).float()
    k6_cases = [
        ("route_b_reflected", designs["route_b"], reflected(designs["route_b"], x_main)),
        ("route_b_n_minus_7", designs["route_b"], reflected(designs["route_b"], x_main[: n - 7])),
        ("order1_T251_n_minus_7", designs["order1"], x_main[: n - 7, 5:].contiguous() - 1000.0),
        ("order3_reflected", designs["order3"], reflected(designs["order3"], x_main)),
        ("order6_reflected", designs["order6"], reflected(designs["order6"], x_main)),
        (f"route_b_{FILTER_LONG_ROW}", designs["route_b"], long6 - 1000.0),
    ]
    for tag, sos, x in k6_cases:
        zi = torch.as_tensor(rng6.normal(0, 20, (2 * sos.shape[0], x.shape[0])),
                             dtype=torch.float32, device=dev)
        for reverse in (False, True):
            before = flc.sosfilt_cuda.launches
            out = flc.sosfilt_cuda(x, sos, zi, reverse=reverse)
            torch.cuda.synchronize()
            check(flc.sosfilt_cuda.launches == before + 1, f"sosfilt {tag}: kernel not launched")
            err = filter_equal(flt.sosfilt_plain(x, sos, zi, reverse=reverse), out,
                               f"sosfilt {tag} reverse={reverse}")
            max_err["sosfilt"] = max(max_err["sosfilt"], err)
        parity["sosfilt"].append(f"{tag} {x.shape[0]}x{x.shape[1]} S={sos.shape[0]}")
    print(f"parity sosfilt: {len(k6_cases)} cases, forward and reverse, bit-equal to "
          f"sosfilt_plain: {'; '.join(parity['sosfilt'])}; {flc.sosfilt_layout(4)}", flush=True)
    del long6, k6_cases
    sos = designs["route_b"]
    b5, b6 = flc.sosfiltfilt_cuda.launches, flc.sosfilt_cuda.launches
    two = flc.sosfiltfilt_cuda(x_main, sos, fused=False)
    torch.cuda.synchronize()
    check(flc.sosfilt_cuda.launches == b6 + 2 and flc.sosfiltfilt_cuda.launches == b5,
          "two-pass mode: K6 not launched twice")
    fused = flc.sosfiltfilt_cuda(x_main, sos)
    err = max(filter_equal(fused, two, "sosfilt two-pass vs fused"),
              filter_equal(flt.sosfiltfilt_plain(x_main, sos), two, "sosfilt two-pass vs plain"))
    max_err["sosfilt"] = max(max_err["sosfilt"], err)
    # the two-pass step's own operations: the reflection, K6 twice, the
    # centre plus the DC response; no transposing copy and no flip
    ops = step_ops(lambda: flc.sosfiltfilt_cuda(x_main, sos, fused=False))
    moved = [k for k in ops["aten"] if k in ("aten::t", "aten::transpose", "aten::permute",
                                             "aten::flip")]
    check(not moved, f"the two-pass step ran {moved}")
    print(f"parity sosfilt two_pass_route_b: ok, K6 launched twice, bit-equal to K5 and the "
          f"plain version; step ops at {n}x{L} (torch.profiler): device {ops['device']}; "
          f"aten {ops['aten']}", flush=True)
    b5, b6 = flc.sosfiltfilt_cuda.launches, flc.sosfilt_cuda.launches
    short = x_main[:, :20]  # L = 20 <= padlen 27: passes through
    out = flt.sosfiltfilt(short, sos)
    check(torch.equal(out, short) and (flc.sosfiltfilt_cuda.launches, flc.sosfilt_cuda.launches)
          == (b5, b6), "pass-through of L <= padlen launched a kernel or changed the waves")
    print("parity sosfiltfilt pass_through_L20: ok, no launch, waves unchanged", flush=True)
    for window, poly in ((11, 2), (21, 3)):
        a, b = flt.savgol(w_main, window, poly), flt.savgol(w_main.cpu(), window, poly)
        rel = float(((a.cpu().double() - b.double()).abs() / b.double().abs()).max())
        check(rel <= SG_RTOL, f"SG {window}/{poly}: card vs CPU relative {rel:.3g} > {SG_RTOL}")
        print(f"parity savgol window {window} poly {poly}: card = CPU within rtol {SG_RTOL} "
              f"(largest relative difference {rel:.3g})", flush=True)
    del two, fused, out, short

    stamp("phase 3 (parity)")

    # ---- phase 4: main path of slice 1 (make_chain_scan) ------------------
    # each main path runs with every kernel's count set to 0 just before it
    kernels = {"chain_scan": csc.chain_scan_cuda, "chain_tile": ctc.chain_tile_cuda,
               "peaks_scan": csc.find_peaks_scan,
               "hits_scan": csc.threshold_hits_scan, "width_scan": wsc.width_crossings_scan,
               "sosfiltfilt": flc.sosfiltfilt_cuda, "sosfilt": flc.sosfilt_cuda}
    batch = batch_from_numpy(*main_np, device=dev)
    step = csc.make_chain_scan(bench_cfg)
    for fn in kernels.values():
        fn.launches = 0
    out = step(*batch)
    torch.cuda.synchronize()
    launches = {"chain_scan": csc.chain_scan_cuda.launches}
    check(launches["chain_scan"] >= 1, "main path did not launch the chain kernel")
    counts = check_chain_counts(out, dev, n, "main path 1")
    print(f"main path 1: make_chain_scan on {n}x{L}: {launches['chain_scan']} kernel "
          f"launch(es); {counts} (= JAX reference)", flush=True)

    # ---- phase 4c: main path of slice 4 (the facade's make_chain_tile) ----
    tile_step = wa.make_chain_tile(bench_cfg)
    for fn in kernels.values():
        fn.launches = 0
    out = tile_step(*batch)
    torch.cuda.synchronize()
    got = {name: fn.launches for name, fn in kernels.items()}
    launches["chain_tile"] = got["chain_tile"]
    check(got["chain_tile"] >= 1 and all(v == 0 for k, v in got.items() if k != "chain_tile"),
          f"main path 4: launches {got}, expected chain_tile only")
    counts = check_chain_counts(out, dev, n, "main path 4")
    print(f"main path 4: wa.make_chain_tile on {n}x{L}: launches {got}; {counts} "
          f"(= JAX reference)", flush=True)
    demo = fused_chain_demo.main(device="cuda", n_events=n)
    check(all(demo["agree"].values()), f"fused-chain demo: implementations disagree {demo['agree']}")
    print(f"main path 4 demo at {n} events: tile and scan chains = the plain chain on "
          f"{list(fused_chain_demo.AGREE_KEYS)}; accuracy "
          f"{ {k: v['accuracy'] for k, v in demo['results'].items()} }", flush=True)
    del out, demo

    # ---- phase 4p: models.pipeline (plain torch, no kernel) ----------------
    # forward_step on bench.py's waves with mixed polarity and ragged valid
    # lengths, on the card against the same step on the CPU: ints exact,
    # f32 within atol 1e-3 / rtol 1e-4 (sums in another order)
    from waveformanalysis_tpu_torch.models import pipeline as pipe

    p_np = (main_np[0], ragged_np[1], ragged_np[3])
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    p_out = pipe.make_jit_step()(*(torch.from_numpy(a).to(dev) for a in p_np))
    torch.cuda.synchronize()
    p_wall = time.perf_counter() - t0
    got = {name: fn.launches for name, fn in kernels.items()}
    check(not any(got.values()), f"models.pipeline launched kernels: {got}")
    p_ref = pipe.forward_step(*(torch.from_numpy(a) for a in p_np), pipe.PipelineConfig())
    p_err = compare(p_ref, p_out, "models.pipeline card vs CPU")
    labels = p_out["label"].cpu()
    print(f"models.pipeline forward_step on {n}x{L} (card = CPU, max |f32 diff| {p_err:.3g}; "
          f"first call {p_wall * 1e3:.1f} ms): S1 {int((labels == 1).sum())}, S2 "
          f"{int((labels == 2).sum())}, no kernel launched", flush=True)
    del p_out, p_ref

    # ---- phase 4t: slice 16, the port's tools (chain fuzz, install check) --
    tool_launches = tools_phase(kernels)

    stamp("phases 4, 4c and 4t")

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
        route_err, where = max(compare_tables(cpu_tables[m], gpu_tables[m], m)
                               for m in MEMBERS)
        lab = np.asarray(gpu_tables["s1_s2"]["label"])
        print(f"main path 2: Context get_data(['s1_s2', 'hit_threshold']) on {n}x{L}: "
              f"launches { {k: launches[k] for k in route_kernels} }; tables "
              f"{ {m: len(t) for m, t in gpu_tables.items()} }, S1 {int(np.sum(lab == 1))}, "
              f"S2 {int(np.sum(lab == 2))}; every member table = the CPU Context's "
              f"(max |f32 diff| {route_err:.3g}, {where}; CPU route {t_cpu:.1f} s)", flush=True)
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

    stamp("phase 5")

    # ---- phase 5b: main paths of slice 3 (routes A and B) ------------------
    for route in ("A", "B"):
        cfg, bl = FILTER_ROUTES[route]
        st = st_waveforms_from_waves(main_np[0], baseline=bl)
        n_groups = len(np.unique(st["channel"]))
        with tempfile.TemporaryDirectory() as tmp:
            ctx = make_route_context(Context, filter_plugins, f"{tmp}/cuda", "cuda", cfg)
            ctx.inject_data("r", "st_waveforms", st)
            for fn in kernels.values():
                fn.launches = 0
            ctx.get_data("r", ["s1_s2", "hit_threshold"])
            torch.cuda.synchronize()
            got = {name: fn.launches for name, fn in kernels.items()}
            if route == "A":  # SG; standalone hit (K2), fused hit_threshold (K3),
                # standalone waveform_width (width_from_peaks, no kernel)
                want = {"sosfiltfilt": 0, "width_scan": 0, "sosfilt": 0}
                check(got["peaks_scan"] >= 1 and got["hits_scan"] >= 1,
                      f"route A: launches {got}")
            else:  # one K5 launch per hardware channel, then the fused program
                want = {"sosfiltfilt": n_groups, "sosfilt": 0}
                check(all(got[k] >= 1 for k in ("peaks_scan", "hits_scan", "width_scan")),
                      f"route B: launches {got}")
                launches.update(sosfiltfilt=got["sosfiltfilt"], sosfilt=got["sosfilt"])
            check(all(got[k] == v for k, v in want.items()),
                  f"route {route}: launches {got}, expected {want}")
            standalone = standalone_members(ctx)
            check(standalone == FILTER_STANDALONE[route],
                  f"route {route}: standalone members {standalone}, JAX plan "
                  f"{FILTER_STANDALONE[route]}")
            names = ("filtered_waveforms",) + MEMBERS
            gpu_tables = {m: ctx.get_data("r", m) for m in names}
            wave = gpu_tables["filtered_waveforms"]["wave"]
            check(isinstance(wave, np.ndarray) and wave.dtype == np.float32,
                  "the cached filtered waves are not a host float32 matrix after get_data")
            on_card = [key for key, t in ctx._results.items() if isinstance(t, Table) and any(
                isinstance(v, torch.Tensor) and v.is_cuda for v in t.columns.values())]
            check(not on_card, f"route {route}: cached tables with columns on the card {on_card}")
            ctx.flush_saves()

            t_cpu = time.perf_counter()
            ctx_cpu = make_route_context(Context, filter_plugins, f"{tmp}/cpu", "cpu", cfg)
            ctx_cpu.inject_data("r", "st_waveforms", st)
            ctx_cpu.get_data("r", ["s1_s2", "hit_threshold"])
            cpu_tables = {m: ctx_cpu.get_data("r", m) for m in names}
            ctx_cpu.flush_saves()
            t_cpu = time.perf_counter() - t_cpu
            a, b = np.asarray(cpu_tables["filtered_waveforms"]["wave"]), wave
            wave_err = float(np.max(np.abs(a.astype(np.float64) - b)))
            if route == "A":
                ok = bool(np.isclose(b, a, rtol=SG_RTOL, atol=0).all())
            else:
                ok = wave_err <= BW_WAVE_ATOL
            check(ok, f"route {route}: filtered waves differ from the CPU Context's by {wave_err:.3g}")
            route_err, where = max(compare_tables(
                cpu_tables[m].drop("wave") if m == names[0] else cpu_tables[m],
                gpu_tables[m].drop("wave") if m == names[0] else gpu_tables[m],
                f"route {route}/{m}") for m in names)
            lab = np.asarray(gpu_tables["s1_s2"]["label"])
            print(f"main path 3{route.lower()}: route {route} get_data(['s1_s2', 'hit_threshold']) "
                  f"on {n}x{L}: launches {got}; standalone {sorted(standalone)}; tables "
                  f"{ {m: len(gpu_tables[m]) for m in MEMBERS} }, S1 {int(np.sum(lab == 1))}, "
                  f"S2 {int(np.sum(lab == 2))}; filtered waves = the CPU Context's (max "
                  f"|diff| {wave_err:.3g}), every member table = the CPU Context's (max "
                  f"|f32 diff| {route_err:.3g}, {where}; CPU route {t_cpu:.1f} s)", flush=True)
            del ctx, ctx_cpu, gpu_tables, cpu_tables, wave, a, b

            ctx = make_route_context(Context, filter_plugins, f"{tmp}/ref", "cuda", cfg)
            ctx.inject_data("r", "st_waveforms", st_waveforms_from_waves(
                make_batch(N_FILTER_REF, L, seed=0), baseline=bl))
            ctx.get_data("r", ["s1_s2", "hit_threshold"])
            got = {m: len(ctx.get_data("r", m)) for m in MEMBERS}
            lab = np.asarray(ctx.get_data("r", "s1_s2")["label"])
            got.update(n_s1=int(np.sum(lab == 1)), n_s2=int(np.sum(lab == 2)))
            ctx.flush_saves()
            check(got == REF_FILTER_ROUTES[route], f"route {route} at {N_FILTER_REF} events: "
                  f"{got}, JAX reference {REF_FILTER_ROUTES[route]}")
            print(f"main path 3{route.lower()} at {N_FILTER_REF}x{L}: {got} (= JAX reference)",
                  flush=True)
            del ctx

    stamp("phase 5b")

    # ---- phase 5j: slice 10, the batched multi-run path on injected waves -
    batched_launches = batched_injected_phase(dev, smi, kernels, route_plugins)
    torch.cuda.empty_cache()

    stamp("phase 5j (batched, injected)")

    # ---- phases 5c-5e: slice 8, the path from DAQ files -----------------
    # ---- phases 5f-5i: slice 9, records ingest on the same files ----------
    # ---- phase 5k: slice 10, the batched multi-run path on the files ------
    # ---- phase 5l: slice 11, chunked streaming on the files ---------------
    # ---- phase 5m: slice 12, the surface (server, CLIs) on the files -------
    # ---- phase 5n: slice 13, the user utilities on the files --------------
    # ---- phase 5o: slice 14, a mesh of 8 shards (chains, sort, Context, streams)
    with tempfile.TemporaryDirectory() as files:
        daq = f"{files}/DAQ"
        ingest_launches, written = ingest_phase(dev, smi, kernels, N_INGEST, N_INGEST_CPU, daq)
        records_launches = records_phase(dev, smi, kernels, daq, written, N_INGEST,
                                         N_INGEST_CPU)
        del written
        stamp("phases 5c and 5f-5g (ingest, records)")
        batched_file_launches = batched_files_phase(dev, kernels, daq, "ingest3")
        stamp("phase 5k (batched, files)")
        stream_launches = streaming_phase(dev, smi, kernels, daq, "ingest3", "cmp")
        torch.cuda.empty_cache()
        stamp("phase 5l (streaming)")
        surface = surface_phase(dev, smi, kernels, daq, "ingest3", "cmp")
        torch.cuda.empty_cache()
        stamp("phase 5m (surface)")
        utility_launches = utilities_phase(dev, smi, kernels, daq, "ingest3", "cmp", N_INGEST)
        torch.cuda.empty_cache()
        stamp("phase 5n (user utilities)")
        mesh_launches = mesh_phase(dev, smi, kernels, daq, "ingest3", N_INGEST, N_LARGE)
        torch.cuda.empty_cache()
        stamp("phase 5o (mesh)")
    v1725_phase(dev, smi, kernels, N_V1725)
    primitives_phase(dev, smi, N_PRIMITIVES)
    stamp("phases 5h-5i (V1725, primitives)")
    examples_phase()
    grouping_phase(dev, smi, N_GROUPING)
    tutorial_phase()

    stamp("examples, grouping, tutorial")

    # ---- phase 6: kernel times ---------------------------------------------
    # kernels alone on cold inputs (several copies in turn, more bytes than
    # the 50 MB L2 holds): the event-major rows as the caller holds them
    # (K1-K4, K7), time-major copies for K5/K6; with the plain versions on
    # the same inputs; slot capacity 32, the plugins' default and the
    # Context route's
    times, bounds = {}, {}
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib_chain = csc._library()
    lib_tile = ctc._library()
    tile = ctc.tile_layout(L, ctc.DEFAULT_TILE_ROWS)

    def ptxas(name: str) -> str:
        return "; ".join(f"{kernel_tag(p['function'])}: {p.get('registers')} regs, "
                         f"{p.get('spill_stores')}/{p.get('spill_loads')} B spill st/ld, "
                         f"{p.get('static_smem', 0)} B static smem"
                         for p in built[name].ptxas)

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

        # K1 and K7 in turns: plain, steps, kernels alone, kernels alone,
        # steps, plain; both read the event-major rows, each step includes
        # its wrapper and the fresh input (w + k); then K1's wrapper step on
        # the cold copies the kernels read
        outs1 = csc.chain_outputs(size, dev)
        ptrs1 = csc._Outs(*(outs1[name].data_ptr() for name, _ in csc._OUTS))
        prm1 = csc._params(bench_cfg, size, L)
        w_e = [w + k for k in range(n_copies)]
        vec = int(all(x.data_ptr() % 16 == 0 for x in w_e))
        lay1 = csc.chain_layout(L, w_e[0].data_ptr(), bench_cfg.use_derivative)

        def k1(k):
            err = csc.launch_chain(lib_chain, lay1, w_e[k % n_copies].data_ptr(), el.data_ptr(),
                                   bl.data_ptr(), pol.data_ptr(), ptrs1, prm1, stream)
            check(err == 0, f"chain kernel launch failed: cudaError {err}")

        def k7(k):
            err = lib_tile.wfa_chain_tile(w_e[k % n_copies].data_ptr(), el.data_ptr(),
                                          bl.data_ptr(), pol.data_ptr(), ctypes.byref(ptrs1),
                                          ctypes.byref(prm1), tile.rows, vec,
                                          int(tile.float_row), stream)
            check(err == 0, f"tile chain kernel launch failed: cudaError {err}")

        t_plain = median_ms(lambda k: full_chain_step(w + k, el, bl + k, pol, bench_cfg))
        t_step = median_ms(lambda k: step(w + k, el, bl + k, pol))
        t_tstep = median_ms(lambda k: tile_step(w + k, el, bl + k, pol))
        t_k1 = median_ms(k1)
        t_k7 = median_ms(k7)
        t_k7b = median_ms(k7)
        t_k1b = median_ms(k1)
        t_tstep2 = median_ms(lambda k: tile_step(w + k, el, bl + k, pol))
        t_step2 = median_ms(lambda k: step(w + k, el, bl + k, pol))
        t_plain2 = median_ms(lambda k: full_chain_step(w + k, el, bl + k, pol, bench_cfg))
        t_w1 = median_ms(lambda k: step(w_e[k % n_copies], el, bl, pol))
        times[("chain_scan", size)] = (t_k1, t_plain)
        times[("chain_tile", size)] = (t_k7, t_plain)
        # operations: ~20 per sample in the features / runs / candidate
        # pass every sample goes through (a lower count: the slot passes'
        # work depends on the data); the same reading for K2-K4 below. K7
        # does the same work on the same bytes as K1.
        bounds[("chain_scan", size)] = bound(
            nbytes(w, el, bl, pol, *outs1.values()), 20.0 * size * L)
        bounds[("chain_tile", size)] = bounds[("chain_scan", size)]
        b_ms = bounds[("chain_tile", size)][0]
        print(f"times chain_scan {size}x{L} ({smi}), median ms of 7: plain {t_plain:.3f} / "
              f"{t_plain2:.3f}; make_chain_scan step {t_step:.3f} / {t_step2:.3f} "
              f"({size / t_step * 1e3:.0f} wf/s); kernel alone {t_k1:.3f} / {t_k1b:.3f} "
              f"({size / t_k1 * 1e3:.0f} wf/s, {100 * b_ms / t_k1:.2f} % of the {b_ms:.4f} ms "
              f"bound); wrapper step on the cold copies {t_w1:.3f}; {lay1.path} path, R "
              f"{lay1.R}, {lay1.rows} events per block, {lay1.smem_bytes} B shared memory, "
              f"16-byte loads {lay1.vec}; ptxas "
              f"{ptxas('chain_scan')}", flush=True)
        print(f"times chain_tile {size}x{L} ({smi}), median ms of 7: make_chain_tile step "
              f"{t_tstep:.3f} / {t_tstep2:.3f} ({size / t_tstep * 1e3:.0f} wf/s) against "
              f"make_chain_scan step {t_step:.3f} / {t_step2:.3f}; kernel alone {t_k7:.3f} / "
              f"{t_k7b:.3f} ({size / t_k7 * 1e3:.0f} wf/s) against K1 alone {t_k1:.3f} / "
              f"{t_k1b:.3f}; bound {b_ms:.4f} ms, K7 at {100 * b_ms / t_k7:.2f} %; {tile.rows} "
              f"events per block, {tile.smem_bytes} B dynamic shared memory per block, float32 "
              f"signal row {tile.float_row}, 16-byte row loads {bool(vec)}; ptxas "
              f"{ptxas('chain_tile')}", flush=True)
        del outs1, w_e

        # K2 (one warp per event on the event-major rows): alone and its
        # wrapper step on the same cold copies
        kw2 = dict(height=80.0, prominence=50.0, width=2.0, distance=2, max_peaks=K)
        outs2 = csc._tables(csc._PEAKS_OUTS, size, K, dev)
        ptrs2 = csc._PeaksOut(*(outs2[name].data_ptr() for name, _ in csc._PEAKS_OUTS))
        prm2 = csc._PeaksParams(n=size, L=L, K=K, distance=2, height=80.0,
                                prominence=50.0, width=2.0, rel_height=0.5)
        sig_e = [sig + k for k in range(n_copies)]
        lay2 = csc.row_layout(L, 4, sig_e[0].data_ptr(), csc.PEAK_SLOT_BYTES)

        def k2(k):
            err = lib_peaks.wfa_peaks_scan(sig_e[k % n_copies].data_ptr(), el.data_ptr(),
                                           ctypes.byref(ptrs2), ctypes.byref(prm2), lay2.rows,
                                           int(lay2.staged), int(lay2.vec), stream)
            check(err == 0, f"peaks kernel launch failed: cudaError {err}")

        t_k2 = median_ms(k2)
        t_w2 = median_ms(lambda k: csc.find_peaks_scan(sig_e[k % n_copies], valid_length=el,
                                                       **kw2))
        t_k2b = median_ms(k2)
        t_p2 = median_ms(lambda k: find_peaks_batch(sig + k, valid_length=el, **kw2),
                         iters=5, warmup=1)
        times[("peaks_scan", size)] = (t_k2, t_p2)
        bounds[("peaks_scan", size)] = bound(nbytes(sig, el, *outs2.values()), 8.0 * size * L)
        b2 = bounds[("peaks_scan", size)][0]
        print(f"times peaks_scan {size}x{L} K={K} ({smi}): kernel alone {t_k2:.3f} / "
              f"{t_k2b:.3f} ms ({100 * b2 / t_k2:.2f} % of the {b2:.4f} ms bound), wrapper "
              f"step {t_w2:.3f} ms, plain find_peaks_batch {t_p2:.3f} ms; {lay2.rows} events "
              f"per block, {lay2.smem_bytes} B shared memory, 16-byte copies {lay2.vec}",
              flush=True)
        pos = outs2["position"].clone()
        del outs2, sig_e

        # K3 (one warp per event on the event-major rows): alone and its
        # wrapper step on the same cold copies
        outs3 = csc._tables(csc._HITS_OUTS, size, K, dev)
        ptrs3 = csc._HitsOut(*(outs3[name].data_ptr() for name, _ in csc._HITS_OUTS))
        prm3 = csc._HitsParams(n=size, L=L, K=K, left_extension=2, right_extension=2)
        sig_e = [sig + k for k in range(n_copies)]
        lay3 = csc.row_layout(L, 4, sig_e[0].data_ptr(), csc.HIT_SLOT_BYTES)

        def k3(k):
            err = lib_hits.wfa_hits_scan(sig_e[k % n_copies].data_ptr(), thr.data_ptr(),
                                         el.data_ptr(), ctypes.byref(ptrs3), ctypes.byref(prm3),
                                         lay3.rows, int(lay3.staged), int(lay3.vec), stream)
            check(err == 0, f"hits kernel launch failed: cudaError {err}")

        t_k3 = median_ms(k3)
        t_w3 = median_ms(lambda k: csc.threshold_hits_scan(sig_e[k % n_copies], thr, el,
                                                           max_hits=K))
        t_k3b = median_ms(k3)
        t_p3 = median_ms(lambda k: threshold_hits_batch(sig + k, thr, el, max_hits=K),
                         iters=5, warmup=1)
        times[("hits_scan", size)] = (t_k3, t_p3)
        bounds[("hits_scan", size)] = bound(nbytes(sig, thr, el, *outs3.values()),
                                            4.0 * size * L)
        b3 = bounds[("hits_scan", size)][0]
        print(f"times hits_scan {size}x{L} K={K} ({smi}): kernel alone {t_k3:.3f} / "
              f"{t_k3b:.3f} ms ({100 * b3 / t_k3:.2f} % of the {b3:.4f} ms bound), wrapper "
              f"step {t_w3:.3f} ms, plain threshold_hits_batch {t_p3:.3f} ms; "
              f"{int(outs3['valid'].sum())} runs; {lay3.rows} events per block, "
              f"{lay3.smem_bytes} B shared memory, 16-byte copies {lay3.vec}; ptxas "
              f"{ptxas('hits_scan')}", flush=True)
        del outs3, sig_e

        # K4 on K2's slots (int16 waves, as in the Context route)
        blw = w.float()[:, :50].sum(dim=1) / 50
        outs4 = {key: torch.empty((size, K), dtype=torch.int32 if key.endswith("_idx")
                                  else torch.float32, device=dev) for key in wsc.OUT_KEYS}
        ptrs4 = wsc._WidthOut(*(outs4[key].data_ptr() for key in wsc.OUT_KEYS))
        prm4 = wsc._WidthParams(n=size, L=L, K=K, interpolation=1, rise_low=0.1,
                                rise_high=0.9, fall_high=0.9, fall_low=0.1)

        w_e = [w + k for k in range(n_copies)]
        lay4 = csc.row_layout(L, 2, w_e[0].data_ptr())

        def k4(k):
            err = lib_width.wfa_width_scan(w_e[k % n_copies].data_ptr(), 0, blw.data_ptr(),
                                           pos.data_ptr(), ctypes.byref(ptrs4),
                                           ctypes.byref(prm4), lay4.rows, int(lay4.staged),
                                           int(lay4.vec), stream)
            check(err == 0, f"width kernel launch failed: cudaError {err}")

        t_k4 = median_ms(k4)
        t_w4 = median_ms(lambda k: wsc.width_crossings_scan(w_e[k % n_copies], blw, pos,
                                                            0.1, 0.9, 0.9, 0.1))
        t_k4b = median_ms(k4)
        t_p4 = median_ms(lambda k: wsc.width_crossings_plain(w + k, blw, pos, 0.1, 0.9, 0.9, 0.1),
                         iters=5, warmup=1)
        times[("width_scan", size)] = (t_k4, t_p4)
        bounds[("width_scan", size)] = bound(nbytes(w, blw, pos, *outs4.values()),
                                             2.0 * size * L)
        b4 = bounds[("width_scan", size)][0]
        print(f"times width_scan {size}x{L} K={K} ({smi}): kernel alone {t_k4:.3f} / "
              f"{t_k4b:.3f} ms ({100 * b4 / t_k4:.2f} % of the {b4:.4f} ms bound), wrapper "
              f"step {t_w4:.3f} ms, plain width_crossings_plain {t_p4:.3f} ms; "
              f"{int((pos >= 0).sum())} occupied slots; {lay4.rows} events per block, "
              f"{lay4.smem_bytes} B shared memory, 16-byte copies {lay4.vec}", flush=True)
        del w, sig, w_e, outs4, pos
        torch.cuda.empty_cache()

    # K5 alone on cold event-major f32 copies (two in turn, each larger than
    # L2) with their conditioning columns, then its wrapper step on the same
    # copies (the conditioning and the launch) and on int16 copies (the cast
    # too, as route B hands it the gathered st rows); the plain version on the
    # same waves. K6 alone on the event-major reflected rows (forward; in
    # reverse beside it), its wrapper and plain version. Route B's design and
    # config 3's.
    lib_flt = flc._library()
    for size in (N_EVENTS, N_LARGE):
        w_e = [w_main.repeat(size // n, 1) + k for k in range(2)]
        x_e = [w.float() for w in w_e]
        for dname in ("route_b", "config3"):
            sos = designs[dname]
            S, padlen = sos.shape[0], flt.sosfiltfilt_padlen(sos)
            Lp = L + 2 * padlen
            coef = flc.coefficient_table(sos, dev)
            cond = [flt.condition(x, sos) for x in x_e]
            lay5 = flc.filter_layout(L, padlen)
            out5 = torch.empty((size, L), device=dev)
            prm5 = flc._SosParams(n=size, L=L, S=S, padlen=padlen)

            def k5(k):
                m, d = cond[k % 2]
                err = lib_flt.wfa_sosfiltfilt(x_e[k % 2].data_ptr(), m.data_ptr(), d.data_ptr(),
                                              coef.data_ptr(), out5.data_ptr(), None,
                                              ctypes.byref(prm5), lay5.stride, stream)
                check(err == 0, f"sosfiltfilt kernel launch failed: cudaError {err}")

            t_k5 = median_ms(k5)
            t_w5 = median_ms(lambda k: flc.sosfiltfilt_cuda(x_e[k % 2], sos))
            t_i5 = median_ms(lambda k: flc.sosfiltfilt_cuda(w_e[k % 2], sos))
            t_k5b = median_ms(k5)
            t_p5 = median_ms(lambda k: flt.sosfiltfilt_plain(x_e[k % 2], sos), iters=3, warmup=1)
            xc = x_e[0] - cond[0][0]
            ext = [flt.reflect(xc + k, padlen) for k in range(2)]  # event-major (size, Lp)
            del xc
            zi = flt._zi_times(sos, ext[0][:, 0])
            y6 = torch.empty((size, Lp), device=dev)
            prm6 = flc._SosParams(n=size, L=Lp, S=S, padlen=0)

            def k6(reverse):
                def run(k):
                    err = lib_flt.wfa_sosfilt(ext[k % 2].data_ptr(), zi.data_ptr(),
                                              coef.data_ptr(), y6.data_ptr(), ctypes.byref(prm6),
                                              int(reverse), stream)
                    check(err == 0, f"sosfilt kernel launch failed: cudaError {err}")
                return run

            t_k6 = median_ms(k6(False))
            t_k6r = median_ms(k6(True))
            t_w6 = median_ms(lambda k: flc.sosfilt_cuda(ext[k % 2], sos, zi))
            t_p6 = median_ms(lambda k: flt.sosfilt_plain(ext[k % 2], sos, zi),
                             iters=3, warmup=1)
            # bytes: each input read once, each output written once; work:
            # the float32 operations each kernel does (K5: sosfiltfilt_ops,
            # K6: 9 per section and sample), at the non-FMA rate (the
            # kernels are built with --fmad=false)
            b5 = bound_at(nbytes(x_e[0], *cond[0], out5), sosfiltfilt_ops(L, padlen, S) * size,
                          F32_NONFMA_OPS_PER_S)
            b6 = bound_at(nbytes(ext[0], zi, y6), Lp * S * 9.0 * size, F32_NONFMA_OPS_PER_S)
            if dname == "route_b":  # the kernels' records: route B's design
                times[("sosfiltfilt", size)], bounds[("sosfiltfilt", size)] = (t_k5, t_p5), b5
                times[("sosfilt", size)], bounds[("sosfilt", size)] = (t_k6, t_p6), b6
            print(f"times sosfiltfilt {size}x{L} {dname} (S={S}, padlen {padlen}) ({smi}), "
                  f"median ms: kernel alone {t_k5:.3f} / {t_k5b:.3f} ({size / t_k5 * 1e3:.0f} "
                  f"wf/s), wrapper step on event-major f32 rows (conditioning + launch) "
                  f"{t_w5:.3f}, on int16 rows (+ the cast) {t_i5:.3f}, plain sosfiltfilt_plain "
                  f"{t_p5:.3f}; bound {b5[0]:.4f} ms by {b5[1]} ({100 * b5[0] / t_k5:.1f} %); "
                  f"{lay5}; ptxas {ptxas('sosfilt')}", flush=True)
            print(f"times sosfilt {size}x{Lp} {dname} event-major ({smi}), median ms: kernel "
                  f"alone {t_k6:.3f} (reverse {t_k6r:.3f}), wrapper {t_w6:.3f}, plain "
                  f"sosfilt_plain {t_p6:.3f}; bound {b6[0]:.4f} ms by {b6[1]} "
                  f"({100 * b6[0] / t_k6:.1f} %); {flc.sosfilt_layout(S)}", flush=True)
            del ext, zi, y6, cond, out5
        # the K5 step's own device and aten operations: the conditioning and
        # the kernel, no transposing copy
        if size == N_LARGE:
            ops = step_ops(lambda: flc.sosfiltfilt_cuda(x_e[0], designs["route_b"]))
            moved = [k for k in ops["aten"] if k in ("aten::t", "aten::transpose",
                                                     "aten::permute", "aten::copy_")]
            check(not moved, f"the K5 step on f32 rows ran {moved}")
            print(f"K5 step ops at {size}x{L} f32 (torch.profiler): device {ops['device']}; "
                  f"aten {ops['aten']}", flush=True)
        del w_e, x_e
        torch.cuda.empty_cache()

    # rows too long for K5's tile: its long-row mode (a thread walking its row
    # in a global scratch) beside the two-pass step (the reflection and K6
    # twice, each in 128-sample chunks), both from the event-major rows, on
    # cold copies in turns (long-row, two-pass, two-pass, long-row)
    sos = designs["route_b"]
    long_w = torch.from_numpy(make_batch(8_192, FILTER_LONG_ROW, seed=7)).to(dev)
    x_long = [long_w.float().repeat(N_EVENTS // 8_192, 1) + k for k in range(2)]
    del long_w
    check(not flc.filter_layout(FILTER_LONG_ROW, flt.sosfiltfilt_padlen(sos)).staged,
          "K5 stages 4,096-sample rows in its tile")
    fused_step = lambda k: flc.sosfiltfilt_cuda(x_long[k % 2], sos)
    two_step = lambda k: flc.sosfiltfilt_cuda(x_long[k % 2], sos, fused=False)
    check(torch.equal(fused_step(0), two_step(0)), "long rows: two-pass differs from K5")
    t_long = [median_ms(f) for f in (fused_step, two_step, two_step, fused_step)]
    print(f"times long rows {N_EVENTS}x{FILTER_LONG_ROW} route_b ({smi}), median ms in turns: "
          f"K5 long-row step {t_long[0]:.3f} / {t_long[3]:.3f}, two-pass step "
          f"{t_long[1]:.3f} / {t_long[2]:.3f} (bit-equal)", flush=True)
    del x_long
    torch.cuda.empty_cache()

    stamp("phase 6 (kernel times)")

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
        ctx.inject_data("prof", "st_waveforms",
                        st_waveforms_from_waves(make_batch(N_EVENTS, L, seed=seed + 1)))
        profile_route(ctx, "prof", f"{N_EVENTS}x{L}", smi)
        del ctx

    # routes A and B the same way; each run's waves are one batch per size
    # shifted by the run's index (fresh input without a new batch per run).
    # When get_data returns, the Context has moved the run's device columns
    # (the filtered waves) to the host: its own profiler phase
    # (context.release_device_columns), and the memory allocated after each
    # run stays flat. Route B also runs in turns without that release (the
    # columns are moved after the timed call instead), so its cost shows in
    # the wall: cold, then with, with, without, without, with, with, without.
    for route in ("A", "B"):
        cfg, bl = FILTER_ROUTES[route]
        order = (True,) * 4 if route == "A" else (True, True, False, False, True, True, False)
        with tempfile.TemporaryDirectory() as tmp:
            ctx = make_route_context(Context, filter_plugins, tmp, "cuda", cfg)
            release = ctx._release_device_columns
            for size in (N_EVENTS, N_LARGE):
                base = make_batch(size, L, seed=300 + size % 97)
                walls, flushes, phases, peaks, held = [], [], [], [], []
                for i, released in enumerate(order):
                    rid = f"{route}{size}_{i}"
                    ctx.inject_data(rid, "st_waveforms",
                                    st_waveforms_from_waves(base + np.int16(i), baseline=bl))
                    ctx.profiler.reset()
                    deferred = []
                    if not released:
                        ctx._release_device_columns = lambda keys: deferred.extend(keys) or {}
                    torch.cuda.reset_peak_memory_stats(dev)
                    before = torch.cuda.memory_allocated(dev)
                    t0 = time.perf_counter()
                    res = ctx.get_data(rid, ["s1_s2", "hit_threshold"])
                    walls.append(time.perf_counter() - t0)
                    ctx._release_device_columns = release
                    release(deferred)
                    check(len(res["s1_s2"]) > 0, f"route {route} {rid}: no s1_s2 rows")
                    peaks.append((torch.cuda.max_memory_allocated(dev) / 1e9,
                                  (torch.cuda.max_memory_allocated(dev) - before) / 1e9))
                    phases.append(route_phases(ctx))
                    t0 = time.perf_counter()
                    ctx.flush_saves()
                    flushes.append(time.perf_counter() - t0)
                    held.append(torch.cuda.memory_allocated(dev) / 1e9)
                    check(not isinstance(ctx.get_data(rid, "filtered_waveforms")["wave"],
                                         torch.Tensor), f"route {route} {rid}: filtered waves "
                          f"still on the card after get_data")
                warm = [i for i in range(1, len(order)) if order[i]]
                med = statistics.median(walls[i] for i in warm)
                med_ph = {k: round(statistics.median(phases[i].get(k, 0.0) for i in warm), 1)
                          for k in phases[warm[0]]}
                est = (f" (estimate {ROUTE_B_PEAK_ESTIMATE_GB} GB)"
                       if route == "B" and size == N_LARGE else "")
                turns = ""
                if route == "B":
                    kept = [i for i in range(1, len(order)) if not order[i]]
                    turns = (f"; without the release, in turns: runs "
                             f"{[round(walls[i] * 1e3, 1) for i in kept]} ms, median "
                             f"{statistics.median(walls[i] for i in kept) * 1e3:.1f} ms")
                print(f"route {route} {size}x{L} ({smi}): cold {walls[0]:.3f} s; warm median "
                      f"of {len(warm)} {med * 1e3:.1f} ms = {size / med:.0f} waveforms/s (runs "
                      f"{[round(walls[i] * 1e3, 1) for i in warm]} ms){turns}; phases ms "
                      f"{med_ph}; flush_saves median "
                      f"{statistics.median(flushes[i] for i in warm) * 1e3:.1f} ms; "
                      f"peak device memory per run (max_memory_allocated, and above the "
                      f"run's start) {sorted({(round(a, 3), round(b, 3)) for a, b in peaks})} "
                      f"GB{est}; "
                      f"allocated after each run "
                      f"{[round(x, 3) for x in held]} GB", flush=True)
                del base
            if route == "B":
                ctx.inject_data("prof", "st_waveforms", st_waveforms_from_waves(
                    make_batch(N_EVENTS, L, seed=399), baseline=bl))
                profile_route(ctx, "prof", f"B {N_EVENTS}x{L}", smi)
            del ctx
        torch.cuda.empty_cache()
    # route B's K5 launches and their neighbours on the device timeline, in a
    # process of its own (this process's later profiler sessions drop
    # records: the profile above shows one of the two K5 launches)
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--trace-route-b"],
                          capture_output=True, text=True, timeout=600, cwd=ROOT)
    print(proc.stdout.strip(), flush=True)
    check(proc.returncode == 0, f"route B trace failed: {proc.stderr.strip()[-3000:]}")

    stamp("phase 7 (route walls)")

    # ---- phase 8: guard and records ----------------------------------------
    leaked = sorted(m for m in sys.modules if m.split(".")[0] == "waveformanalysis_tpu")
    check(not leaked, f"the JAX package was imported: {leaked}")
    check(not any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules),
          "jax was imported")
    replaces = {
        "chain_scan": "waveformanalysis_tpu/ops/chain_scan_pallas.py:90",
        "chain_tile": "waveformanalysis_tpu/ops/chain_pallas.py:80",
        "peaks_scan": "waveformanalysis_tpu/ops/chain_scan_pallas.py:920",
        "hits_scan": "waveformanalysis_tpu/ops/chain_scan_pallas.py:1238",
        "width_scan": "waveformanalysis_tpu/ops/width_scan_pallas.py:59",
        "sosfiltfilt": "waveformanalysis_tpu/ops/filter_pallas.py:125",
        "sosfilt": "waveformanalysis_tpu/ops/filter_pallas.py:50",
    }
    sources = {"sosfiltfilt": "sosfilt", "sosfilt": "sosfilt"}
    records = []
    for name in replaces:
        ms, plain_ms = times[(name, N_EVENTS)]
        b_ms, b_by = bounds[(name, N_EVENTS)]
        records.append({
            "name": name,
            "route": "cuda",
            "source": f"waveformanalysis_tpu_torch/csrc/{sources.get(name, name)}.cu",
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": max_err[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,  # no PyTorch call computes these functions
            "ingest_launches": ingest_launches[name],  # slice 8's route from files
            # slice 9's records routes A and B from the same files
            "records_launches": {r: records_launches[r][name] for r in ("A", "B")},
            # slice 10's batched path: 16 injected runs in one group, and 4
            # runs from the files (K2 there is the standalone hit, one a run)
            "batched_launches": {"injected": batched_launches[name],
                                 "files": batched_file_launches[name]},
            # slice 11's streams over the ingest files: once per chunk
            "stream_launches": {s: got[name] for s, got in stream_launches.items()},
            # slice 12's surface: the server's cold get_data and batched
            # request (2 runs), and waveform-process
            "surface_launches": {s: surface[s][name]
                                 for s in ("server_get_data", "server_batched", "cli")},
            # slice 13's user utilities: the card's df_events request, the
            # strax facade's get_array(hit), the browser and the reloaded
            # user plugin
            "utility_launches": {s: got[name] for s, got in utility_launches.items()},
            # slice 14's mesh of 8 shards: a sharded K1 / K7 step, a mesh
            # Context request, a batched mesh request, the mesh streams
            "mesh_launches": {"chain_step": mesh_launches["chain_step"].get(name, 0),
                              **{s: got[name] for s, got in mesh_launches.items()
                                 if s != "chain_step"}},
            # slice 16's chain fuzz: K1 and K7 once a trial
            "tool_launches": {"fuzz": tool_launches[name]},
        })
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    t0 = time.perf_counter()
    if sys.argv[1:] == ["--trace-route-b"]:
        trace_route_b()
        sys.exit(0)
    main()
    print(f"# chip_smoke.py finished in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
