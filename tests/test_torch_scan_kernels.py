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
