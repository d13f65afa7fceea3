"""The port's scan-kernel modules against the JAX package on the CPU.

``find_peaks_scan``, ``threshold_hits_scan`` (ops/chain_scan_cuda.py) and
``width_crossings_scan`` (ops/width_scan_cuda.py) run on CPU tensors here,
so through their plain versions; the same numpy inputs go through the JAX
wrappers: once each in Pallas interpret mode, otherwise through the XLA
contract functions the JAX tests pin the Pallas kernels to.

Tolerance: integer, index, count and validity outputs exact; float32
outputs atol 1e-3 / rtol 1e-4. Slot values are compared where the slot's
``valid`` mask is set, as the JAX package compares its kernels
(tests/test_chain_scan_pallas.py); width crossings on occupied slots, the
rows the hit mask emits.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from waveformanalysis_tpu.ops import chain_scan_pallas as jscan
from waveformanalysis_tpu.ops import hits as jhits
from waveformanalysis_tpu.ops import peaks as jpeaks
from waveformanalysis_tpu.ops import width_scan_pallas as jwscan
from waveformanalysis_tpu.ops import widths as jwidths
from waveformanalysis_tpu_torch.ops import chain_scan_cuda as tscan
from waveformanalysis_tpu_torch.ops import width_scan_cuda as twscan
from waveformanalysis_tpu_torch.ops import widths as twidths
from test_torch_scan_kernels_cuda import hit_cases, peak_cases, tie_batch

ATOL, RTOL = 1e-3, 1e-4
PEAK_SLOT_FIELDS = ("peak_value", "prominence", "left_ips", "right_ips", "widths",
                    "left_bases", "right_bases")
HIT_SLOT_FIELDS = ("position", "height", "integral", "seg_start", "seg_end",
                   "run_start", "run_end")


def _same(a, b, key, mask=None):
    a, b = np.asarray(a), b.numpy()
    assert a.dtype == b.dtype, (key, a.dtype, b.dtype)
    assert a.shape == b.shape, (key, a.shape, b.shape)
    if mask is not None:
        a, b = a[mask], b[mask]
    if np.issubdtype(a.dtype, np.floating):
        np.testing.assert_allclose(b, a, atol=ATOL, rtol=RTOL, err_msg=key)
    else:
        np.testing.assert_array_equal(b, a, err_msg=key)


def _compare(ref, out, slot_fields):
    assert set(out) == set(ref)
    valid = np.asarray(ref["valid"])
    for k in ref:
        _same(ref[k], out[k], k, valid if k in slot_fields else None)


def _waves(n, L, seed, noise=3.0):
    """int16 pulses (one event in five empty) on a 1000 baseline, plus
    ragged valid lengths."""
    rng = np.random.default_rng(seed)
    t = np.arange(L)
    c = rng.integers(12, L - 12, n)
    amp = rng.choice([300.0, 150.0], n) * (np.arange(n) % 5 != 0)
    w = 1000.0 + amp[:, None] * np.exp(
        -((t[None, :] - c[:, None]) ** 2) / (2 * rng.uniform(1.5, 10, n)[:, None] ** 2))
    w += rng.normal(0, noise, w.shape)
    return np.round(w).astype(np.int16), rng.integers(L // 2, L + 1, n).astype(np.int32)


# ---------------------------------------------------------------------------
# K2: find_peaks_scan
# ---------------------------------------------------------------------------

def test_find_peaks_scan_against_pallas_interpret():
    """One interpret-mode run of the Pallas kernel (n = L = 96)."""
    waves, vlen = _waves(96, 96, seed=11, noise=12.0)
    sig = waves.astype(np.float32) - 1000.0
    kw = dict(height=30.0, prominence=10.0, width=1.0, distance=3, max_peaks=8)
    ref = jscan.find_peaks_scan(jnp.asarray(sig), valid_length=jnp.asarray(vlen),
                                interpret=True, **kw)
    out = tscan.find_peaks_scan(torch.as_tensor(sig), valid_length=torch.as_tensor(vlen), **kw)
    assert int(np.asarray(ref["valid"]).sum()) > 20  # peaks were found
    _compare(ref, out, PEAK_SLOT_FIELDS)


@pytest.mark.parametrize("case", ["ties_k32_d1", "ties_k32_d3", "ties_k1_d2"])
def test_find_peaks_scan_k32_ties(case):
    """K = 32, the routes' slot capacity, on an int16-quantised batch full
    of equal samples (plateaus, equal minima on both sides of a peak) with
    ragged valid lengths: the tie rules decide every integer output.
    Distance 1 goes through the Pallas kernel in interpret mode (about a
    minute on the CPU at K = 32); with distance > 1 its K x K priority loop
    takes that mode many minutes, so those cases go through the XLA
    contract the JAX package's tests pin the Pallas kernel to."""
    _, sig, vlen, kw = next(c for c in peak_cases() if c[0] == case)
    if kw["distance"] == 1:
        ref = jscan.find_peaks_scan(jnp.asarray(sig), valid_length=jnp.asarray(vlen),
                                    interpret=True, **kw)
    else:
        ref = jpeaks.find_peaks_batch(jnp.asarray(sig), valid_length=jnp.asarray(vlen), **kw)
    out = tscan.find_peaks_scan(torch.as_tensor(sig), valid_length=torch.as_tensor(vlen), **kw)
    assert int(np.asarray(ref["valid"]).sum()) > (20 if kw["max_peaks"] == 1 else 50)
    if kw["max_peaks"] == 32:
        assert int(np.asarray(ref["n_candidates"]).max()) > 8  # slots past K = 8 are used
    _compare(ref, out, PEAK_SLOT_FIELDS)


@pytest.mark.parametrize("case", ["varlen_distance3", "derivative", "overflow_k2",
                                  "plateaus", "full_length"])
def test_find_peaks_scan_against_xla_contract(case):
    waves, vlen = _waves(256, 128, seed=5, noise=10.0)
    sig = waves.astype(np.float32) - 1000.0
    kw = dict(height=30.0, prominence=10.0, width=1.0, distance=3, max_peaks=8)
    if case == "derivative":  # L - 1 columns, valid length - 1
        sig = np.diff(waves.astype(np.float32), axis=1)
        vlen = np.maximum(vlen - 1, 0)
        kw.update(height=8.0, prominence=4.0)
    elif case == "overflow_k2":
        kw.update(max_peaks=2, distance=1, height=5.0, prominence=1.0)
    elif case == "plateaus":
        sig = np.zeros((64, 96), np.float32)
        rng = np.random.default_rng(9)
        for i in range(64):
            j = rng.integers(10, 60)
            sig[i, j:j + rng.integers(2, 6)] = 100.0
        vlen = np.full(64, 96, np.int32)
        kw.update(height=10.0, prominence=0.0, width=0.0, distance=1)
    vl = None if case == "full_length" else vlen
    ref = jpeaks.find_peaks_batch(jnp.asarray(sig), valid_length=None if vl is None
                                  else jnp.asarray(vl), **kw)
    out = tscan.find_peaks_scan(torch.as_tensor(sig), valid_length=None if vl is None
                                else torch.as_tensor(vl), **kw)
    if case == "overflow_k2":
        assert (np.asarray(ref["n_candidates"]) > 2).any()
    _compare(ref, out, PEAK_SLOT_FIELDS)


# ---------------------------------------------------------------------------
# K3: threshold_hits_scan
# ---------------------------------------------------------------------------

def test_threshold_hits_scan_against_pallas_interpret():
    """One interpret-mode run of the Pallas kernel (n = L = 96)."""
    rng = np.random.default_rng(5)
    sig = rng.normal(0, 15, (96, 96)).astype(np.float32)
    sig[:, 30:45] += 80
    sig[:, 70:72] += 60
    sig[:, -4:] += 90  # runs to the wave end
    vlen = rng.integers(48, 97, 96).astype(np.int32)
    thr = rng.uniform(20, 60, 96).astype(np.float32)
    kw = dict(left_extension=2, right_extension=3, max_hits=4)
    ref = jscan.threshold_hits_scan(jnp.asarray(sig), jnp.asarray(thr), jnp.asarray(vlen),
                                    interpret=True, **kw)
    out = tscan.threshold_hits_scan(torch.as_tensor(sig), torch.as_tensor(thr),
                                    torch.as_tensor(vlen), **kw)
    _compare(ref, out, HIT_SLOT_FIELDS)


@pytest.mark.parametrize("case", ["per_event_thresholds", "runs_to_boundary_overflow",
                                  "no_runs"])
def test_threshold_hits_scan_against_xla_contract(case):
    rng = np.random.default_rng(7)
    n, L = 128, 96
    kw = dict(left_extension=2, right_extension=2, max_hits=8)
    sig = rng.normal(0, 15, (n, L)).astype(np.float32)
    vlen = rng.integers(L // 2, L + 1, n).astype(np.int32)
    thr = rng.uniform(20, 60, n).astype(np.float32)
    if case == "runs_to_boundary_overflow":
        sig = np.zeros((n, L), np.float32)
        for i in range(10):
            sig[:, 5 + 9 * i: 8 + 9 * i] = 100.0
        sig[:, 90:] = 100.0  # runs into the wave end
        vlen = np.full(n, L, np.int32)
        vlen[::2] = 93  # ... or into the valid length
        thr = np.full(n, 30.0, np.float32)
        kw = dict(left_extension=1, right_extension=4, max_hits=4)
    elif case == "no_runs":
        thr = np.full(n, 1e6, np.float32)
    ref = jhits.threshold_hits_batch(jnp.asarray(sig), jnp.asarray(thr), jnp.asarray(vlen), **kw)
    out = tscan.threshold_hits_scan(torch.as_tensor(sig), torch.as_tensor(thr),
                                    torch.as_tensor(vlen), **kw)
    if case == "runs_to_boundary_overflow":
        assert (np.asarray(ref["n_runs"]) > 4).all()
    _compare(ref, out, HIT_SLOT_FIELDS)


@pytest.mark.parametrize("case", [c[0] for c in hit_cases()])
def test_threshold_hits_scan_warp_cases(case):
    """The cases the warp-per-event kernel's design turns on (runs that
    straddle its 32-sample steps, runs open at the valid length, one run
    over the whole row, a comb of many runs, K = 1, K = 40 in two chunks of
    slots, L = 250, ragged valid lengths): the plain version against the
    Pallas kernel in interpret mode up to K = 8, against the XLA contract
    above (interpret mode compiles the K slot accumulators for minutes)."""
    _, sig, thr, vlen, kw = next(c for c in hit_cases() if c[0] == case)
    args = (jnp.asarray(sig), jnp.asarray(thr), jnp.asarray(vlen))
    if kw["max_hits"] <= 8:
        ref = jscan.threshold_hits_scan(*args, interpret=True, **kw)
    else:
        ref = jhits.threshold_hits_batch(*args, **kw)
    out = tscan.threshold_hits_scan(torch.as_tensor(sig), torch.as_tensor(thr),
                                    torch.as_tensor(vlen), **kw)
    n_runs = np.asarray(ref["n_runs"])
    assert (n_runs > kw["max_hits"]).any() and n_runs.max() > 32  # slots overflow
    assert (np.asarray(ref["run_end"])[:, 0] == 0).sum() < len(sig)  # runs were found
    _compare(ref, out, HIT_SLOT_FIELDS)


# ---------------------------------------------------------------------------
# K4: width_crossings_scan and the slot widths around it
# ---------------------------------------------------------------------------

def _slots(waves, K):
    """Realistic slot tables: find_peaks over the corrected signal, empty
    slots at position -1."""
    sig = jnp.asarray(waves, jnp.float32) - 1000.0
    peaks = jpeaks.find_peaks_batch(sig, height=40.0, prominence=20.0, width=1.0,
                                    distance=2, max_peaks=K)
    valid = np.array(peaks["valid"])
    return np.where(valid, np.asarray(peaks["position"]), -1).astype(np.int32), valid


def test_width_crossings_scan_against_pallas_interpret():
    """One interpret-mode run of the Pallas kernel (n = L = 96)."""
    waves, _ = _waves(96, 96, seed=3)
    pos, _ = _slots(waves, K=4)
    bl = (waves[:, :50].astype(np.float32).sum(axis=1) / 50).astype(np.float32)
    fr = (0.1, 0.9, 0.9, 0.1)
    ref = jwscan.width_crossings_scan(jnp.asarray(waves), jnp.asarray(bl), jnp.asarray(pos),
                                      *fr, interpret=True)
    out = twscan.width_crossings_scan(torch.as_tensor(waves), torch.as_tensor(bl),
                                      torch.as_tensor(pos), *fr)
    occ = pos >= 0
    assert occ.sum() > 20
    assert set(out) == set(ref)
    for k in ref:
        _same(ref[k], out[k], k, occ)
    # empty slots: no peak value, nothing found
    empty = ~occ
    assert (out["peak_value"].numpy()[empty] == 0).all()
    assert (out["r_low_idx"].numpy()[empty] == waves.shape[1]).all()


@pytest.mark.parametrize("case", ["k4_empty_column", "all_empty", "k1"])
def test_width_crossings_scan_unaligned_against_pallas_interpret(case):
    """L = 250 (rows that are not 16-byte aligned): real slots beside an
    all-empty slot column, an all-empty table, and a single slot."""
    waves, _ = tie_batch(64, 250, seed=12)
    pos, _ = _slots(waves, K=4)
    pos[:, 3] = -1
    if case == "all_empty":
        pos[:] = -1
    elif case == "k1":
        pos = np.ascontiguousarray(pos[:, :1])
    bl = (waves[:, :50].astype(np.float32).sum(axis=1) / 50).astype(np.float32)
    ref = jwscan.width_crossings_scan(jnp.asarray(waves), jnp.asarray(bl), jnp.asarray(pos),
                                      0.1, 0.9, 0.9, 0.1, interpret=True)
    out = twscan.width_crossings_scan(torch.as_tensor(waves), torch.as_tensor(bl),
                                      torch.as_tensor(pos), 0.1, 0.9, 0.9, 0.1)
    assert set(out) == set(ref)
    occ = pos >= 0
    assert (occ.sum() > 20) == (case != "all_empty")
    for k in ref:  # the occupied slots, the rows the hit mask emits
        _same(ref[k], out[k], k, occ)
        # empty slots: no peak value, nothing found (the port's contract)
        assert (out[k].numpy()[~occ] == (250 if k.endswith("_idx") else 0)).all(), k


@pytest.mark.parametrize("interpolation", [True, False])
@pytest.mark.parametrize("as_float", [False, True])
def test_width_slots_scan_against_xla_contract(interpolation, as_float):
    """width_from_peak_slots_scan (through the crossings' plain version)
    against the JAX package's width_from_peak_slots on every consumed
    output: width_valid everywhere, values on occupied slots."""
    waves, _ = _waves(300, 64, seed=4)
    pos, valid = _slots(waves, K=8)
    pos[:5, 7] = [0, 63, 31, -1, 70]  # edge and out-of-range positions
    w = waves.astype(np.float32) if as_float else waves
    ref = jwidths.width_from_peak_slots(jnp.asarray(waves, jnp.float32), jnp.asarray(pos),
                                        jnp.asarray(valid), interpolation=interpolation)
    out = twidths.width_from_peak_slots_scan(torch.as_tensor(w), torch.as_tensor(pos),
                                             torch.as_tensor(valid),
                                             interpolation=interpolation)
    assert set(out) == set(ref)
    _same(ref["width_valid"], out["width_valid"], "width_valid")
    _same(ref["valid"], out["valid"], "valid")
    _same(ref["position"], out["position"], "position")
    occ = (pos >= 0) & (pos < waves.shape[1])
    for k in ("rise_samples", "fall_samples", "total_samples", "peak_height"):
        _same(ref[k], out[k], k, occ)
    assert (np.asarray(ref["width_valid"]) == 1).any()


def test_width_crossings_plain_handles_empty_slots_only():
    waves, _ = _waves(16, 32, seed=8)
    bl = torch.full((16,), 1000.0)
    pos = torch.full((16, 3), -1, dtype=torch.int32)
    pos[:, 2] = 32  # past the wave: empty as well
    out = twscan.width_crossings_scan(torch.as_tensor(waves), bl, pos, 0.1, 0.9, 0.9, 0.1)
    for k, v in out.items():
        expect = 32 if k.endswith("_idx") else 0.0
        assert (v == expect).all(), k


def test_scan_wrappers_reject_mixed_devices():
    x = torch.zeros((4, 16))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tscan.find_peaks_scan(x, 1.0, 1.0, 1.0, valid_length=torch.zeros(4, device="meta"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tscan.threshold_hits_scan(x.to("meta"), torch.zeros(4), torch.zeros(4))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        twscan.width_crossings_scan(x, torch.zeros(4).to("meta"),
                                    torch.zeros((4, 2), dtype=torch.int32), 0.1, 0.9, 0.9, 0.1)


def test_cpu_tensors_never_launch_kernels(monkeypatch):
    """On CPU tensors the wrappers run their plain versions: no build, no
    launch counted."""
    def refuse(*_a, **_k):
        raise AssertionError("a kernel library was requested for CPU tensors")

    monkeypatch.setattr(tscan, "_scan_library", refuse)
    monkeypatch.setattr(twscan, "_library", refuse)
    counts = (tscan.find_peaks_scan.launches, tscan.threshold_hits_scan.launches,
              twscan.width_crossings_scan.launches)
    waves, vlen = _waves(8, 64, seed=1)
    sig = torch.as_tensor(waves.astype(np.float32) - 1000.0)
    tscan.find_peaks_scan(sig, 30.0, 10.0, 1.0, valid_length=torch.as_tensor(vlen))
    tscan.threshold_hits_scan(sig, torch.full((8,), 20.0), torch.as_tensor(vlen))
    twscan.width_crossings_scan(torch.as_tensor(waves), torch.full((8,), 1000.0),
                                torch.zeros((8, 2), dtype=torch.int32), 0.1, 0.9, 0.9, 0.1)
    assert (tscan.find_peaks_scan.launches, tscan.threshold_hits_scan.launches,
            twscan.width_crossings_scan.launches) == counts


def test_row_layout_of_the_warp_kernels():
    """Events per block, shared memory per block, the 16-byte copy flag and
    the switch to rows read from global memory at the shared-memory limit
    (the arithmetic of csrc/warp_rows.cuh)."""
    slot = tscan.PEAK_SLOT_BYTES
    assert tscan.row_layout(256, 4, 4096, slot) == tscan.RowLayout(
        rows=8, smem_bytes=8 * (1024 + slot), staged=True, vec=True)
    assert tscan.row_layout(256, 2, 4096).smem_bytes == 8 * 512  # K4's int16 rows, no tables
    # 16-byte copies only for rows whose length and base are 16-byte aligned
    assert not tscan.row_layout(255, 4, 4096, slot).vec  # the derivative signal
    assert not tscan.row_layout(250, 2, 4096).vec
    assert tscan.row_layout(248, 2, 4096).vec
    assert not tscan.row_layout(256, 4, 4100, slot).vec
    assert tscan.row_bytes(255, 4) == 1024 and tscan.row_bytes(250, 2) == 512
    # fewer events per block where eight rows do not fit, one at the limit
    assert tscan.row_layout(8192, 4, 0, slot).rows == 7
    for elem, sb in ((4, slot), (2, 0)):
        top = tscan.max_staged_length(elem, sb)
        at, past = (tscan.row_layout(L, elem, 0, sb) for L in (top, top + 1))
        assert (at.staged, at.rows) == (True, 1) and at.smem_bytes <= tscan.SMEM_BYTES
        assert not past.staged and not past.vec
        assert (past.rows, past.smem_bytes) == (tscan.ROW_WARPS, tscan.ROW_WARPS * sb)
    # the long rows of chip_smoke.py's phase 3: 65,536 f32 samples are read
    # from global memory, 65,536 int16 samples still fit one block
    assert not tscan.row_layout(65_536, 4, 0, slot).staged
    assert tscan.row_layout(65_536, 2, 0).staged


def test_scan_wrappers_take_event_major_rows(monkeypatch):
    """The CUDA path hands the kernels the event-major rows it was given
    (no transposing copy), with the layout row_layout picks: checked with a
    stand-in library on CPU tensors posing as CUDA tensors."""
    seen = {}

    class Lib:
        def wfa_peaks_scan(self, x, vlen, outs, prm, rows, staged, vec, stream):
            seen["peaks"] = (x, rows, staged, vec)
            return 0

        def wfa_width_scan(self, w, is_float, bl, pos, outs, prm, rows, staged, vec, stream):
            seen["width"] = (w, is_float, rows, staged, vec)
            return 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(tscan, "_peaks_library", Lib)
    monkeypatch.setattr(twscan, "_library", Lib)
    monkeypatch.setattr(tscan, "_devices", lambda *ts: "cuda")
    monkeypatch.setattr(twscan, "_devices", lambda *ts: "cuda")
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    sig = torch.zeros((6, 255))
    tscan.find_peaks_scan(sig, 1.0, 1.0, 1.0, max_peaks=32,
                          valid_length=torch.full((6,), 255, dtype=torch.int32))
    assert seen["peaks"] == (sig.data_ptr(), 8, 1, 0)
    waves = torch.zeros((6, 256), dtype=torch.int16)
    twscan.width_crossings_scan(waves, torch.zeros(6), torch.zeros((6, 3), dtype=torch.int32),
                                0.1, 0.9, 0.9, 0.1)
    assert seen["width"] == (waves.data_ptr(), 0, 8, 1, int(waves.data_ptr() % 16 == 0))


def test_row_layout_of_the_chain_and_hit_kernels():
    """K1's int16 rows with its two slot tables and K3's f32 rows with its
    run tables: events per block, shared memory, the 16-byte flag and, for
    K3 only, the switch to rows read from global memory."""
    chain, hit = tscan.CHAIN_SLOT_BYTES, tscan.HIT_SLOT_BYTES
    assert (chain, hit) == (512, 256)
    assert tscan.row_layout(256, 2, 4096, chain) == tscan.RowLayout(
        rows=8, smem_bytes=8 * (512 + 512), staged=True, vec=True)
    assert tscan.row_layout(256, 4, 4096, hit) == tscan.RowLayout(
        rows=8, smem_bytes=8 * (1024 + 256), staged=True, vec=True)
    assert not tscan.row_layout(250, 2, 4096, chain).vec  # 500-byte rows
    assert tscan.row_layout(248, 2, 4096, chain).vec
    assert not tscan.row_layout(250, 4, 4096, hit).vec
    assert not tscan.row_layout(256, 2, 4098, chain).vec  # an unaligned base
    # the longest int16 row the chain kernel takes (L < 65536) is staged,
    # one event per block
    top = tscan.row_layout(65_535, 2, 0, chain)
    assert (top.staged, top.rows) == (True, 1) and top.smem_bytes == 131_072 + chain
    # K3 reads f32 rows of 65,536 samples from global memory, 8 events a block
    assert tscan.row_layout(65_536, 4, 0, hit) == tscan.RowLayout(
        rows=8, smem_bytes=8 * hit, staged=False, vec=False)
    assert tscan.row_layout(tscan.max_staged_length(4, hit), 4, 0, hit).staged


def test_chain_and_hits_wrappers_take_event_major_rows(monkeypatch):
    """chain_scan_cuda and threshold_hits_scan hand their kernels the
    event-major rows they were given (no transposing copy) with the layout
    chain_layout / row_layout picks: the chain's register path at L = 256
    and 250, its staged path at 300; checked with a stand-in library on CPU
    tensors posing as CUDA tensors."""
    seen = {}

    class Lib:
        def wfa_chain_scan(self, w, el, bl, pol, outs, prm, rows, vec, stream):
            seen["chain"] = (w, el, rows, vec, prm._obj.L, prm._obj.K)
            return 0

        def wfa_chain_scan_regs(self, w, el, bl, pol, outs, prm, rows, R, vec, smem, stream):
            seen["chain"] = (w, el, rows, vec, prm._obj.L, prm._obj.K, R, smem)
            return 0

        def wfa_hits_scan(self, x, thr, vlen, outs, prm, rows, staged, vec, stream):
            seen["hits"] = (x, thr, rows, staged, vec, prm._obj.L, prm._obj.K)
            return 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(tscan, "_library", Lib)
    monkeypatch.setattr(tscan, "_hits_library", Lib)
    monkeypatch.setattr(tscan, "_devices", lambda *ts: "cuda")
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)  # a CPU tensor's index
    monkeypatch.setattr(tscan, "_stream", lambda dev: 0)
    monkeypatch.setattr(tscan, "_PLANS", {})
    counts = (tscan.chain_scan_cuda.launches, tscan.threshold_hits_scan.launches)
    for L in (256, 250):
        waves = torch.zeros((6, L), dtype=torch.int16)
        el = torch.full((6,), L, dtype=torch.int32)
        tscan.chain_scan_cuda(waves, el, torch.zeros(6), torch.ones(6, dtype=torch.int8))
        vec = int(L % 8 == 0 and waves.data_ptr() % 16 == 0)
        # 4 events a block; ChainConfig's derivative signal: a second float32
        # row a warp
        assert seen["chain"] == (waves.data_ptr(), el.data_ptr(), 4, vec, L, 8, 8,
                                 4 * (2 * 1024 + 512))
        sig = torch.zeros((6, L))
        thr = torch.full((6,), 10.0)
        tscan.threshold_hits_scan(sig, thr, el, max_hits=40)
        vec = int(L % 4 == 0 and sig.data_ptr() % 16 == 0)
        assert seen["hits"] == (sig.data_ptr(), thr.data_ptr(), 8, 1, vec, L, 40)
    waves = torch.zeros((6, 300), dtype=torch.int16)
    el = torch.full((6,), 300, dtype=torch.int32)
    tscan.chain_scan_cuda(waves, el, torch.zeros(6), torch.ones(6, dtype=torch.int8))
    assert seen["chain"] == (waves.data_ptr(), el.data_ptr(), 8, 0, 300, 8)
    long_sig = torch.zeros((2, 65_536))
    tscan.threshold_hits_scan(long_sig, torch.zeros(2), torch.zeros(2, dtype=torch.int32))
    assert seen["hits"][:5] == (long_sig.data_ptr(), seen["hits"][1], 8, 0, 0)
    assert (tscan.chain_scan_cuda.launches, tscan.threshold_hits_scan.launches) == (
        counts[0] + 3, counts[1] + 3)
