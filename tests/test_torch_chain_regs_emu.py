"""The chain kernel's register path (``csrc/warp_chain_regs.cuh``) run on
the CPU against the port's plain ``full_chain_step``.

The warp code itself, compiled with g++ against a host emulation of the warp
intrinsics (``tests/warp_emu/``: a warp is 32 fibers of one thread, which
hand over in lane order at every shuffle, ballot and reduction), on
tie-heavy int16 waves with ragged lengths and mixed polarity, at every R
(1, 2, 4, 8 samples a lane), with and without the derivative signal,
16-byte and element row loads.
The two overflow counters are the sums of the flags chain_event_regs
returns, as the kernel's atomic adds count them. Tolerance: integer, index,
count, validity, label and counter outputs exact; float32 outputs atol 1e-3
/ rtol 1e-4 (the register path adds the width baseline
and hit_integral in another order). The emulator's intrinsics are held to
CUDA's definitions on known lane values, and a divergent warp must fail with
its lane named (``test_warp_emulator_intrinsics``). On the card,
tests/test_torch_scan_kernels_cuda.py holds the kernel itself.
"""

import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_scan_kernels_cuda import tie_batch
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
    the overflow flags chain_event_regs returns."""
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
    assert off == len(raw)
    return out


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
    out = run_emulated(emulator, tmp_path, w, vl, bl, pol, cfg, samples)
    assert list(out) == list(ref)
    for k, a in ref.items():
        b = out[k]
        assert b.dtype == a.dtype and b.shape == a.shape, k
        if a.dtype.is_floating_point:
            torch.testing.assert_close(b, a, atol=ATOL, rtol=RTOL, msg=k)
        else:
            assert torch.equal(b, a), (k, (b != a).nonzero().flatten()[:8].tolist())
    if cfg_name == "dense_k32_d2" and length >= 100:
        assert int(ref["n_peaks"].sum()) > 0 and int(ref["n_hits"].sum()) > 0
    if cfg_name == "dense_k32_d2" and length >= 250:  # the flags' sums are not all 0
        assert int(ref["n_peak_overflow"]) > 0 and int(ref["n_hit_overflow"]) > 0


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
