"""The port's chain ops against their JAX counterparts on the CPU.

The same numpy inputs (from seeds) go through each JAX function and its
PyTorch port. Tolerance: integer, index, count and validity outputs exact;
float32 outputs atol 1e-3 / rtol 1e-4.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from waveformanalysis_tpu.ops import features as jfeat
from waveformanalysis_tpu.ops import hits as jhits
from waveformanalysis_tpu.ops import peaks as jpeaks
from waveformanalysis_tpu.ops import widths as jwidths
from waveformanalysis_tpu_torch.ops import features as tfeat
from waveformanalysis_tpu_torch.ops import hits as thits
from waveformanalysis_tpu_torch.ops import peaks as tpeaks
from waveformanalysis_tpu_torch.ops import widths as twidths

ATOL, RTOL = 1e-3, 1e-4


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


def _pulses(n, L, seed, noise=20.0):
    rng = np.random.default_rng(seed)
    t = np.arange(L)
    c = rng.integers(20, L - 20, n)
    amp = rng.choice([250.0, -200.0, 0.0], n)
    w = 1000.0 + amp[:, None] * np.exp(
        -((t[None, :] - c[:, None]) ** 2) / (2 * rng.uniform(2, 12, n)[:, None] ** 2))
    w += rng.normal(0, noise, w.shape)
    return np.round(w).astype(np.int16), rng.integers(L // 3, L + 1, n).astype(np.int32)


@pytest.mark.parametrize("windows", [
    dict(height_start=40, height_end=90, area_start=0, area_end=None),
    dict(height_start=0, height_end=None, area_start=10, area_end=60),
    dict(height_start=100, height_end=128, area_start=5, area_end=128),
])
@pytest.mark.parametrize("as_float", [False, True])
def test_feature_reductions(windows, as_float):
    waves, el = _pulses(48, 128, seed=1)
    el[:3] = (0, 1, 45)  # empty, single-sample and short events
    src = waves.astype(np.float32) + 0.25 if as_float else waves
    ref = jfeat.feature_reductions(jnp.asarray(src), jnp.asarray(el), **windows)
    out = tfeat.feature_reductions(torch.as_tensor(src), torch.as_tensor(el), **windows)
    assert set(out) == set(ref)
    for k in ref:
        _same(ref[k], out[k], k)


def test_compact_first_k():
    rng = np.random.default_rng(2)
    flags = rng.random((32, 64)) < 0.1
    vals = rng.normal(size=(32, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(64, dtype=np.int32), (32, 64))
    (jv, jp), jok = jpeaks.compact_first_k(jnp.asarray(flags), (jnp.asarray(vals), jnp.asarray(pos)),
                                           4, (-5.0, -1))
    (tv, tp), tok = tpeaks.compact_first_k(torch.as_tensor(flags),
                                           (torch.as_tensor(vals), torch.as_tensor(pos.copy())),
                                           4, (-5.0, -1))
    for key, a, b in (("values", jv, tv), ("positions", jp, tp), ("ok", jok, tok)):
        _same(a, b, key)


def _noise_pulse(seed=7, n=40, L=128):
    rng = np.random.default_rng(seed)
    sig = rng.normal(0, 30, (n, L)).astype(np.float32)
    sig[:, 50:60] += 200
    return sig, rng.integers(L // 2, L + 1, n).astype(np.int32)


def _plateaus(seed=9):
    rng = np.random.default_rng(seed)
    sig = np.zeros((16, 96), np.float32)
    for i in range(16):
        j = rng.integers(10, 60)
        sig[i, j:j + rng.integers(1, 6)] = 100.0
        sig[i, j + 12] = 100.0  # an equal-height neighbour: distance ties
    return sig, np.full(16, 96, np.int32)


FIND_PEAKS_CASES = {
    "noise_pulse_varlen_distance3": (_noise_pulse, dict(
        height=30.0, prominence=10.0, width=1.0, distance=3, max_peaks=8)),
    "plateaus_distance1": (_plateaus, dict(
        height=10.0, prominence=0.0, width=0.0, distance=1, max_peaks=8)),
    "plateau_ties_distance14": (_plateaus, dict(
        height=10.0, prominence=0.0, width=0.0, distance=14, max_peaks=8)),
    "overflow_k4_rel_height": (_noise_pulse, dict(
        height=0.0, prominence=1.0, width=0.5, distance=2, max_peaks=4,
        rel_height=0.75)),
    "neighbour_threshold": (_noise_pulse, dict(
        height=20.0, prominence=5.0, width=0.5, distance=1, max_peaks=16,
        threshold=(2.0, 60.0))),
}


@pytest.mark.parametrize("case", sorted(FIND_PEAKS_CASES))
def test_find_peaks_batch(case):
    make, kw = FIND_PEAKS_CASES[case]
    sig, vlen = make()
    ref = jpeaks.find_peaks_batch(jnp.asarray(sig), valid_length=jnp.asarray(vlen), **kw)
    out = tpeaks.find_peaks_batch(torch.as_tensor(sig), valid_length=torch.as_tensor(vlen),
                                  **kw)
    assert set(out) == set(ref)
    valid = np.asarray(ref["valid"])
    assert valid.any()
    for k in ("valid", "position", "n_candidates", "peak_value"):
        _same(ref[k], out[k], k)
    # slot values beyond the validity mask are not part of the contract
    for k in ("prominence", "left_ips", "right_ips", "widths", "left_bases", "right_bases"):
        _same(ref[k], out[k], k, mask=valid)


@pytest.mark.parametrize("method", ["minmax", "diff"])
def test_peak_heights_batch(method):
    sig, vlen = _noise_pulse(seed=3)
    peaks = jpeaks.find_peaks_batch(jnp.asarray(sig), 30.0, 10.0, 1.0, distance=2,
                                    max_peaks=8, valid_length=jnp.asarray(vlen))
    waves = (sig + 1000).astype(np.float32)
    args = [np.array(peaks[k]) for k in ("left_ips", "right_ips", "valid")]
    ref = jpeaks.peak_heights_batch(jnp.asarray(waves), *map(jnp.asarray, args), method=method)
    out = tpeaks.peak_heights_batch(torch.as_tensor(waves), *map(torch.as_tensor, args),
                                    method=method)
    _same(ref, out, method)


def _hits_compare(sig, thr, vlen, **kw):
    ref = jhits.threshold_hits_batch(jnp.asarray(sig), jnp.asarray(thr), jnp.asarray(vlen), **kw)
    out = thits.threshold_hits_batch(torch.as_tensor(sig), torch.as_tensor(thr),
                                     torch.as_tensor(vlen), **kw)
    assert set(out) == set(ref)
    for k in ref:
        _same(ref[k], out[k], k)
    return out


def test_threshold_hits_per_event_thresholds():
    rng = np.random.default_rng(5)
    n, L = 40, 128
    sig = rng.normal(0, 15, (n, L)).astype(np.float32)
    sig[:, 30:45] += 80
    sig[:, 70:72] += 60
    vlen = rng.integers(L // 2, L + 1, n).astype(np.int32)
    thr = rng.uniform(20, 60, n).astype(np.float32)
    _hits_compare(sig, thr, vlen, left_extension=2, right_extension=2, max_hits=8)


def test_threshold_hits_run_to_boundary_and_overflow():
    sig = np.zeros((4, 96), np.float32)
    for i in range(10):
        sig[:, 5 + 9 * i: 8 + 9 * i] = 100.0
    sig[:, 90:] = 100.0  # runs into the wave end
    out = _hits_compare(sig, np.full(4, 30.0, np.float32), np.full(4, 96, np.int32),
                        left_extension=1, right_extension=1, max_hits=4)
    assert (out["n_runs"] > 4).all()  # overflow is counted, not silent


@pytest.mark.parametrize("interpolation", [True, False])
def test_width_from_peaks(interpolation):
    waves, _ = _pulses(48, 128, seed=6, noise=3.0)
    rng = np.random.default_rng(6)
    w32 = waves.astype(np.float32)
    pos = np.argmax(np.abs(w32 - 1000.0), axis=1).astype(np.int32)
    pos[:4] = (-1, 0, 127, 200)  # invalid and edge positions
    pos[4:8] = rng.integers(0, 128, 4)
    kw = dict(rise_low=0.1, rise_high=0.9, fall_high=0.8, fall_low=0.2,
              interpolation=interpolation)
    ref = jwidths.width_from_peaks(jnp.asarray(w32), jnp.asarray(pos), **kw)
    out = twidths.width_from_peaks(torch.as_tensor(w32), torch.as_tensor(pos), **kw)
    assert set(out) == set(ref)
    for k in ref:
        _same(ref[k], out[k], k)
