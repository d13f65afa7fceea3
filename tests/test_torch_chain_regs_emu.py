"""The chain kernel's register path (``csrc/warp_chain_regs.cuh``) run on
the CPU against the port's plain ``full_chain_step``.

The warp code itself, compiled with g++ against a host emulation of the warp
intrinsics (``tests/warp_emu/``: a warp is 32 fibers of one thread, which
hand over in lane order at every shuffle, ballot and reduction), on
tie-heavy int16 waves with ragged lengths and mixed polarity, at every R
(1, 2, 4, 8 samples a lane), with and without the derivative signal,
16-byte and element row loads.
The two overflow counters are the sums of the flags chain_event_regs
returns, as the kernel's atomic adds count them. The kept slots its
prominence screen takes off the walks, whose count it returns too, equal
a numpy count (``screened_slots``) on those waves, the benchmark's waves,
rows where the screen's bound meets the prominence and hand-made edge
rows. Tolerance: integer, index,
count, validity, label and counter outputs exact; float32 outputs atol 1e-3
/ rtol 1e-4 (the register path adds the width baseline
and hit_integral in another order). The emulator's intrinsics are held to
CUDA's definitions on known lane values, and a divergent warp must fail with
its lane named (``test_warp_emulator_intrinsics``). On the card,
tests/test_torch_scan_kernels_cuda.py holds the kernel itself.
"""

import dataclasses
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_scan_kernels_cuda import screen_batch, tie_batch
from waveformanalysis_tpu_torch.models.full_chain import (
    CHAIN_OUT_KEYS,
    ChainConfig,
    full_chain_step,
)
from waveformanalysis_tpu_torch.ops import chain_scan_cuda as csc

ROOT = Path(__file__).resolve().parents[1]
EMU = ROOT / "tests" / "warp_emu"
CSRC = ROOT / "waveformanalysis_tpu_torch" / "csrc"
ATOL, RTOL = 1e-3, 1e-4
CFGS = {
    "bench": ChainConfig(use_derivative=False, peak_height=80.0, peak_prominence=50.0,
                         peak_width=2.0),
    "derivative_k32": ChainConfig(use_derivative=True, peak_height=8.0, peak_prominence=4.0,
                                  peak_width=1.0, peak_distance=3, max_peaks=32, max_hits=32),
    "dense_k32_d2": ChainConfig(use_derivative=False, peak_height=8.0, peak_prominence=4.0,
                                peak_width=0.5, peak_distance=2, max_peaks=32, max_hits=32,
                                hit_threshold=8.0),
}
NP_TYPES = {torch.float32: np.float32, torch.int32: np.int32, torch.int8: np.int8}


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    exe = tmp_path_factory.mktemp("warp_emu") / "chain_regs_emu"
    proc = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-include",
         str(EMU / "cuda_runtime.h"), f"-I{EMU}", f"-I{CSRC}", str(EMU / "chain_regs_emu.cpp"),
         "-o", str(exe)], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return exe


def run_emulated(exe, tmp_path, waves, el, bl, pol, cfg, R):
    """The register chain's 14 outputs on the host, as chain_scan_cuda
    returns them: the 12 per-event outputs and, as 0-d int32, the sums of
    the overflow flags chain_event_regs returns; and the sum of the kept
    slots its prominence screen took off the walks."""
    n, L = waves.shape
    src, dst = tmp_path / "in.bin", tmp_path / "out.bin"
    src.write_bytes(np.array([n, L], np.int32).tobytes() + bytes(csc._params(cfg, n, L))
                    + waves.astype(np.int16).tobytes() + el.astype(np.int32).tobytes()
                    + bl.astype(np.float32).tobytes() + pol.astype(np.int8).tobytes())
    subprocess.run([str(exe), str(src), str(dst), str(R)], check=True, timeout=60)
    raw, off, out = dst.read_bytes(), 0, {}
    for name, dt in csc._OUTS:
        size = np.dtype(NP_TYPES[dt]).itemsize * (n if name in CHAIN_OUT_KEYS else 1)
        arr = np.frombuffer(raw[off:off + size], NP_TYPES[dt]).copy()
        out[name] = torch.from_numpy(arr if name in CHAIN_OUT_KEYS else arr.reshape(()))
        off += size
    assert off + 4 == len(raw)
    return out, int(np.frombuffer(raw[off:], np.int32)[0])


def screened_slots(waves, el, bl, pol, cfg):
    """The kept slots the register chain's prominence screen takes off the
    walks, counted in numpy row by row: the candidates (scipy's plateau
    midpoints on the detection values at or above the height, the first
    max_peaks by position), the greedy distance pruning (the higher value
    first, the later slot among equals), then, in rows with two kept slots
    or more, each kept slot below v_max, the highest kept value, whose value
    less the minimum of the row between it and p_m, the first slot at v_max
    (both included), falls below the prominence."""
    sign = np.where(pol > 0, 1.0, -1.0).astype(np.float32)[:, None]
    w32 = waves.astype(np.float32)
    el = np.clip(el, 0, waves.shape[1])
    if cfg.use_derivative:
        det, det_len = sign * (w32[:, 1:] - w32[:, :-1]), np.maximum(el - 1, 0)
    else:
        det, det_len = sign * (w32 - bl.astype(np.float32)[:, None]), el
    prom, total = np.float32(cfg.peak_prominence), 0
    for x, n in zip(det, det_len):
        pos, val, i = [], [], 1
        while i < n - 1:
            if x[i - 1] < x[i]:
                ahead = i + 1
                while ahead < n - 1 and x[ahead] == x[i]:
                    ahead += 1
                if x[ahead] < x[i]:
                    if x[i] >= cfg.peak_height:
                        pos.append((i + ahead - 1) // 2)
                        val.append(x[i])
                    i = ahead
            i += 1
        pos, val = pos[:cfg.max_peaks], val[:cfg.max_peaks]
        keep = [True] * len(pos)
        if cfg.peak_distance > 1:
            for j in sorted(range(len(pos)), key=lambda j: (-val[j], -j)):
                if keep[j]:
                    for m in range(len(pos)):
                        if m != j and abs(pos[m] - pos[j]) < cfg.peak_distance:
                            keep[m] = False
        kept = [(p, v) for p, v, k in zip(pos, val, keep) if k]
        if len(kept) < 2:
            continue
        v_max = max(v for _, v in kept)
        p_m = min(p for p, v in kept if v == v_max)
        total += sum(1 for p, v in kept
                     if v < v_max and v - x[min(p, p_m):max(p, p_m) + 1].min() < prom)
    return total


def assert_same(out, ref):
    """Integer, index, count, label and counter outputs exact; float32
    outputs within the tolerance."""
    assert list(out) == list(ref)
    for k, a in ref.items():
        b = out[k]
        assert b.dtype == a.dtype and b.shape == a.shape, k
        if a.dtype.is_floating_point:
            torch.testing.assert_close(b, a, atol=ATOL, rtol=RTOL, msg=k)
        else:
            assert torch.equal(b, a), (k, (b != a).nonzero().flatten()[:8].tolist())


def _batch(n, L, seed):
    rng = np.random.default_rng(seed)
    if L >= 8:
        w, vl = tie_batch(n, L, seed)
    else:
        w = (1000 + rng.integers(-40, 40, (n, L))).astype(np.int16)
        vl = rng.integers(0, L + 1, n).astype(np.int32)
    bl = (1000 + rng.integers(-3, 4, n)).astype(np.float32)
    pol = rng.choice(np.array([-1, 0, 1], np.int8), n)
    return w, vl, bl, pol


@pytest.mark.parametrize("cfg_name", sorted(CFGS))
@pytest.mark.parametrize("length,samples", [(2, 1), (31, 1), (33, 2), (100, 4), (250, 8),
                                            (256, 8), (33, 8)])
def test_register_chain_matches_plain_on_host(emulator, tmp_path, length, samples, cfg_name):
    """R = chain_layout's at each L, and R = 8 on a 33-sample row (most
    lanes past the row's end)."""
    if samples == csc.reg_samples(length):
        assert csc.chain_layout(length, 0, False).R == samples
    cfg = CFGS[cfg_name]
    w, vl, bl, pol = _batch(48, length, seed=100 + length)
    ref = full_chain_step(*(torch.from_numpy(a) for a in (w, vl, bl, pol)), cfg)
    out, screened = run_emulated(emulator, tmp_path, w, vl, bl, pol, cfg, samples)
    assert_same(out, ref)
    assert screened == screened_slots(w, vl, bl, pol, cfg)
    if cfg_name == "dense_k32_d2" and length >= 100:
        assert int(ref["n_peaks"].sum()) > 0 and int(ref["n_hits"].sum()) > 0
    if cfg_name == "dense_k32_d2" and length >= 250:  # the flags' sums are not all 0
        assert int(ref["n_peak_overflow"]) > 0 and int(ref["n_hit_overflow"]) > 0


BENCH_CFGS = {
    "bench": CFGS["bench"],
    "bench_d3": dataclasses.replace(CFGS["bench"], peak_distance=3),
    "derivative_k32": CFGS["derivative_k32"],
}


@pytest.mark.parametrize("cfg_name", sorted(BENCH_CFGS))
def test_prominence_screen_on_bench_waves(emulator, tmp_path, cfg_name):
    """The benchmark's waves (portbench.gen.make_batch: a narrow pulse on
    even rows, a wide one on odd rows, whose noisy top holds several kept
    slots short of the prominence) at L = 256, R = 8: the outputs equal
    full_chain_step's and the screened slots the numpy count."""
    from portbench.gen import generator, make_batch

    cfg = BENCH_CFGS[cfg_name]
    n, L = 192, 256
    w = make_batch(n, L, generator(3_141_592_653, "cpu")).numpy()
    vl = np.full(n, L, np.int32)
    bl = np.full(n, 1000.0, np.float32)
    pol = np.ones(n, np.int8)
    ref = full_chain_step(*(torch.from_numpy(a) for a in (w, vl, bl, pol)), cfg)
    out, screened = run_emulated(emulator, tmp_path, w, vl, bl, pol, cfg, 8)
    assert_same(out, ref)
    assert screened == screened_slots(w, vl, bl, pol, cfg)
    if cfg_name != "derivative_k32":  # the wide pulses' tops: several a row
        assert screened > n // 2


@pytest.mark.parametrize("length", [256, 250])
def test_prominence_screen_on_screen_rows(emulator, tmp_path, length):
    """The card test's screen_batch at R = 8 with the bench config: the
    outputs equal full_chain_step's and the screened slots the numpy count;
    the even rows' lower peaks are valid where their bound is 50 or 51 and
    screened where it is 49."""
    cfg = CFGS["bench"]
    w, vl = screen_batch(96, length, seed=24 + length)
    n = len(w)
    bl = np.full(n, 1000.0, np.float32)
    pol = np.ones(n, np.int8)
    ref = full_chain_step(*(torch.from_numpy(a) for a in (w, vl, bl, pol)), cfg)
    out, screened = run_emulated(emulator, tmp_path, w, vl, bl, pol, cfg, 8)
    assert_same(out, ref)
    assert screened == screened_slots(w, vl, bl, pol, cfg) > n // 2
    peaks = ref["n_peaks"][0::2]
    assert bool((peaks == 1).any()) and bool((peaks == 2).any())


def knot_rows(rows, L=256):
    """int16 rows on a 1000 baseline, each linear between its knots (sample,
    value above the baseline) and 0 outside them."""
    t = np.arange(L)
    return np.stack([np.round(1000 + np.interp(t, *zip(*knots), left=0, right=0))
                     for knots in rows]).astype(np.int16)


# (knots, kept slots screened, valid peaks) with the bench config: height 80,
# prominence 50. A lower peak at 110 (120 high) beside a higher one at 60
# (200) with a valley of 70, 71 or 69 between: its bound v - g is 50, 49 or
# 51 (and so is its prominence); mirrored with the lower peak on the left;
# slots in p_m's lane (lanes of 8 samples), in lane 31 left of p_m and in
# lane 0 right of it; two tops at v_max with a slot between them; a slot 110
# samples from p_m with every sample between high, and with the one low
# sample (bound 60) 80 samples from it.
EDGE_ROWS = [
    ([(20, 0), (60, 200), (90, 70), (110, 120), (150, 0)], 0, 2),  # bound = prominence
    ([(20, 0), (60, 200), (90, 71), (110, 120), (150, 0)], 1, 1),  # bound 49: screened
    ([(20, 0), (60, 200), (90, 69), (110, 120), (150, 0)], 0, 2),  # bound 51
    ([(100, 0), (140, 120), (160, 70), (190, 200), (230, 0)], 0, 2),  # mirrored
    ([(100, 0), (140, 120), (160, 71), (190, 200), (230, 0)], 1, 1),
    ([(40, 0), (98, 200), (100, 150), (102, 170), (160, 0)], 1, 1),  # p_m's lane, right
    ([(40, 0), (97, 170), (99, 150), (101, 200), (160, 0)], 1, 1),  # p_m's lane, left
    ([(200, 0), (249, 150), (250, 140), (252, 200), (255, 0)], 1, 1),  # lane 31
    ([(0, 0), (2, 200), (3, 140), (5, 150), (60, 0)], 1, 1),  # lane 0
    ([(20, 0), (60, 200), (90, 185), (120, 190), (150, 185), (180, 200), (230, 0)], 1, 2),
    ([(10, 0), (40, 150), (50, 110), (150, 200), (200, 0)], 1, 1),  # 111 samples, all high
    ([(10, 0), (40, 150), (50, 120), (100, 120), (120, 90), (150, 200), (200, 0)], 0, 2),
]


def test_prominence_screen_edges_on_host(emulator, tmp_path):
    """Hand-made rows (EDGE_ROWS) where the screen's bound meets the
    prominence exactly (the slot walks and stays valid), falls one short of
    it or passes it by one, in both directions; slots in p_m's own lane and
    at the row's two ends; equal-valued tops (the second top is not
    screened). The outputs equal full_chain_step's; the screened slots equal
    the numpy count and the rows' own."""
    cfg = CFGS["bench"]
    w = knot_rows([knots for knots, _, _ in EDGE_ROWS])
    n, L = w.shape
    vl = np.full(n, L, np.int32)
    bl = np.full(n, 1000.0, np.float32)
    pol = np.ones(n, np.int8)
    ref = full_chain_step(*(torch.from_numpy(a) for a in (w, vl, bl, pol)), cfg)
    assert ref["n_peaks"].tolist() == [peaks for _, _, peaks in EDGE_ROWS]
    want = sum(cut for _, cut, _ in EDGE_ROWS)
    assert screened_slots(w, vl, bl, pol, cfg) == want
    for i in range(n):  # row by row: each row's own count
        one = tuple(a[i:i + 1] for a in (w, vl, bl, pol))
        assert screened_slots(*one, cfg) == EDGE_ROWS[i][1], i
    out, screened = run_emulated(emulator, tmp_path, w, vl, bl, pol, cfg, 8)
    assert_same(out, ref)
    assert screened == want


LANES = np.arange(32)
V = LANES * 37 % 64 - 20  # the self-test's lane values (chain_regs_emu.cpp)
FLOAT_BITS = np.array([0x7FC00001, -2**31] + [lane * 0x01010101 for lane in range(2, 32)])


def _i32(x):
    return (np.asarray(x, np.int64) + 2**31) % 2**32 - 2**31


def _intrinsic_results(name):
    """What each CUDA intrinsic returns in every lane: label -> 32 values."""
    up, down = name == "shfl_up", name == "shfl_down"
    if name == "shfl":
        out = {f"src={s}": V[np.full(32, s) % 32] for s in (0, 31, 33, -1)}
        return {**out, "src=7l+3": V[(7 * LANES + 3) % 32]}
    if up or down:  # a source lane outside the warp returns the lane's own value
        src = {d: LANES - d if up else LANES + d for d in (0, 1, 5, 31, 32)}
        return {f"delta={d}": np.where((s >= 0) & (s < 32), V[s % 32], V) for d, s in src.items()}
    if name == "shfl_xor":
        out = {f"mask={m}": V[LANES ^ m] for m in (0, 1, 5, 16, 31)}
        return {**out, "float_bits": FLOAT_BITS[LANES ^ 1]}
    if name == "ballot":  # bit i set where lane i's predicate holds, in every lane
        preds = {"l%3==0": LANES % 3 == 0, "none": LANES < 0, "every": LANES >= 0,
                 "l==31": LANES == 31}
        return {label: np.full(32, _i32(int((pred.astype(np.int64) << LANES).sum())))
                for label, pred in preds.items()}
    extremes = np.where(LANES == 7, -2**31, np.where(LANES == 20, 2**31 - 1, LANES))
    red = {"reduce_min": np.min, "reduce_max": np.max, "reduce_add": np.sum}[name]
    return {label: np.full(32, _i32(red(x))) for label, x in (("v", V), ("extremes", extremes))}


@pytest.mark.parametrize("name", ["shfl", "shfl_up", "shfl_down", "shfl_xor", "ballot",
                                  "reduce_min", "reduce_max", "reduce_add", "divergent_return",
                                  "divergent_extra"])
def test_warp_emulator_intrinsics(emulator, name):
    """The emulator's intrinsics against CUDA's definitions, edge lanes
    included; a divergent warp (lane 5 returns before a shuffle, lane 9
    shuffles once more than lane 0) exits non-zero with the lane named
    instead of hanging."""
    proc = subprocess.run([str(emulator), "--selftest", name], capture_output=True, text=True,
                          timeout=60)
    if name.startswith("divergent"):
        lane = 5 if name == "divergent_return" else 9
        assert proc.returncode != 0 and f"divergent warp: lane {lane} " in proc.stderr, proc
        return
    assert proc.returncode == 0, proc.stderr
    got = {label: np.array(vals, np.int64) for label, *vals in map(str.split,
                                                                   proc.stdout.splitlines())}
    want = _intrinsic_results(name)
    assert list(got) == list(want)
    for label, values in want.items():
        np.testing.assert_array_equal(got[label], _i32(values), err_msg=label)
