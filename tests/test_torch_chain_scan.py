"""The port's fused chain against the JAX package on the CPU.

``full_chain_step`` of the port and ``chain_scan_cuda`` on CPU tensors (its
plain path) against the JAX XLA chain ``full_chain_step``, on the cases
tests/test_chain_scan_pallas.py holds the Pallas kernel to, plus one case
against the Pallas kernel itself in interpret mode and bench.py's workload.
Tolerance: integer, index, count, validity and label outputs exact; float32
outputs atol 1e-3 / rtol 1e-4.
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bench import make_batch
from waveformanalysis_tpu.models import full_chain as jchain
from waveformanalysis_tpu_torch.models import full_chain as tchain
from waveformanalysis_tpu_torch.ops.chain_scan_cuda import chain_scan_cuda, make_chain_scan

ATOL, RTOL = 1e-3, 1e-4
BENCH_CFG = dict(use_derivative=False, peak_height=80.0, peak_prominence=50.0,
                 peak_width=2.0)


def _configs(**fields):
    jcfg = jchain.ChainConfig(**fields)
    return jcfg, tchain.ChainConfig.from_fields(dataclasses.asdict(jcfg))


def _assert_same(ref, out, tag=""):
    assert list(out) == list(ref), tag
    for k in ref:
        a, b = np.asarray(ref[k]), out[k].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (tag, k, a.dtype, b.dtype)
        if np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(b, a, err_msg=f"{tag}/{k}")
        else:
            np.testing.assert_allclose(b, a, atol=ATOL, rtol=RTOL, err_msg=f"{tag}/{k}")


def _compare(fields, waves, el, bl, pol):
    jcfg, tcfg = _configs(**fields)
    ref = jchain.full_chain_step(jnp.asarray(waves), jnp.asarray(el), jnp.asarray(bl),
                                 jnp.asarray(pol), jcfg)
    batch = tchain.batch_from_numpy(waves, el, bl, pol, device="cpu")
    _assert_same(ref, tchain.full_chain_step(*batch, tcfg), "full_chain_step")
    _assert_same(ref, chain_scan_cuda(*batch, tcfg), "chain_scan_cuda")
    return ref


def _mixed_waves(n, L, seed=3):
    rng = np.random.default_rng(seed)
    t = np.arange(L)
    waves = np.full((n, L), 1000.0)
    for i in range(n):
        c = rng.integers(50, L - 50)
        amp = rng.choice([300, -280]) if i % 5 else 0
        waves[i] += amp * np.exp(-((t - c) ** 2) / (2 * rng.uniform(2, 20) ** 2))
    waves += rng.normal(0, 3, waves.shape)
    return np.round(waves).astype(np.int16)


RNG = np.random.default_rng(11)
N, L = 50, 192
WAVES = _mixed_waves(N, L)
EL = RNG.integers(L // 2, L + 1, N).astype(np.int32)
BL = np.full(N, 1000.0, np.float32)
POS = np.ones(N, np.int8)
NOISY = (1000 + RNG.normal(0, 40, (N, L))).round().astype(np.int16)
MIXED_POL = RNG.choice(np.array([-1, 1], np.int8), N)
PULSE_CFG = dict(use_derivative=False, peak_height=60.0, peak_prominence=30.0,
                 peak_width=1.5)
DENSE_CFG = dict(use_derivative=False, peak_height=10.0, peak_prominence=2.0,
                 peak_width=0.5, peak_distance=1, max_peaks=16, max_hits=16,
                 hit_threshold=5.0)

CHAIN_CASES = {
    "positive_polarity_varlen": (PULSE_CFG, WAVES, POS),
    "negative_polarity": (PULSE_CFG, WAVES, -POS),
    "derivative_mode": (dict(use_derivative=True, peak_height=20.0, peak_prominence=5.0,
                             peak_width=1.0, peak_distance=3), WAVES, POS),
    "dense_noise_high_capacity": (DENSE_CFG, NOISY, POS),
    "mixed_polarity": (PULSE_CFG, WAVES, MIXED_POL),
}


@pytest.mark.parametrize("case", sorted(CHAIN_CASES))
def test_chain_matches_jax(case):
    fields, waves, pol = CHAIN_CASES[case]
    _compare(fields, waves, EL, BL, pol)


def test_chain_boundary_plateaus():
    w2 = np.full((3, 64), 1000, np.int16)
    w2[0, 10:40] = 1100   # plateau to the el=40 boundary -> no peak
    w2[1, 10:39] = 1100   # falls inside -> midpoint peak
    w2[2, 30] = 1400
    ref = _compare(dict(use_derivative=False, peak_height=50.0, peak_prominence=0.0,
                        peak_width=0.0),
                   w2, np.array([40, 40, 64], np.int32), np.full(3, 1000.0, np.float32),
                   np.ones(3, np.int8))
    np.testing.assert_array_equal(np.asarray(ref["n_peaks"]), [0, 1, 1])


def test_chain_s1_s2_classification():
    jcfg, tcfg = _configs(**BENCH_CFG)
    batch = tchain.example_chain_batch(32, 128, device="cpu")
    jbatch = jchain.example_chain_batch(32, 128)
    for a, b in zip(jbatch, batch):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        assert b.numpy().dtype == np.asarray(a).dtype
    out = make_chain_scan(tcfg)(*batch)
    labels = out["label"].numpy()
    assert (labels[0::2] == 1).all()
    assert (labels[1::2] == 2).all()
    _assert_same(jchain.full_chain_step(*jbatch, jcfg), out)


def test_chain_against_pallas_kernel_interpret():
    """The one comparison with the TPU kernel itself (interpret mode)."""
    from waveformanalysis_tpu.ops.chain_scan_pallas import chain_scan_pallas

    n, length = 40, 128
    waves = _mixed_waves(n, length, seed=5)
    el = np.random.default_rng(5).integers(length // 2, length + 1, n).astype(np.int32)
    bl = np.full(n, 1000.0, np.float32)
    pol = np.random.default_rng(6).choice(np.array([-1, 0, 1], np.int8), n)
    jcfg, tcfg = _configs(**PULSE_CFG)
    ref = chain_scan_pallas(jnp.asarray(waves), jnp.asarray(el), jnp.asarray(bl),
                            jnp.asarray(pol), jcfg, interpret=True)
    out = chain_scan_cuda(*tchain.batch_from_numpy(waves, el, bl, pol, device="cpu"), tcfg)
    assert set(out) == set(ref)
    _assert_same({k: ref[k] for k in out}, out, "pallas")
    assert int(out["n_peaks"].sum()) > 0


@pytest.fixture(scope="module")
def dense_batch():
    return tchain.batch_from_numpy(NOISY, EL, BL, POS, device="cpu")


@pytest.mark.parametrize("policy", ["warn", "raise", "ignore"])
def test_run_chain_overflow_policy(policy, dense_batch, caplog):
    _, tcfg = _configs(**dict(DENSE_CFG, max_peaks=4, max_hits=4))
    caplog.set_level(logging.WARNING)
    if policy == "raise":
        with pytest.raises(tchain.ChainOverflowError, match="max_peaks=4"):
            tchain.run_chain(*dense_batch, tcfg, overflow_policy=policy)
        return
    out = tchain.run_chain(*dense_batch, tcfg, overflow_policy=policy)
    assert int(out["n_peak_overflow"]) > 0 and int(out["n_hit_overflow"]) > 0
    warned = "capacity overflow" in caplog.text
    assert warned == (policy == "warn")


def test_run_chain_quiet_without_overflow_and_rejects_unknown_policy(caplog):
    _, tcfg = _configs(**BENCH_CFG)
    batch = tchain.example_chain_batch(16, 128, device="cpu")
    caplog.set_level(logging.WARNING)
    out = tchain.run_chain(*batch, tcfg, overflow_policy="raise")
    assert int(out["n_peak_overflow"]) == 0 and "overflow" not in caplog.text
    with pytest.raises(ValueError, match="overflow_policy"):
        tchain.run_chain(*batch, tcfg, overflow_policy="strict")


def test_config_and_batch_helpers():
    jcfg, tcfg = _configs(height_range=[10, 50], max_hits=4, rise_low=0.2)
    assert dataclasses.asdict(tcfg) == dict(dataclasses.asdict(jcfg), height_range=(10, 50))
    assert hash(tcfg) == hash(tchain.ChainConfig.from_fields(dataclasses.asdict(tcfg)))
    with pytest.raises(TypeError, match="bogus"):
        tchain.ChainConfig.from_fields({"bogus": 1})
    batch = tchain.batch_from_numpy(np.zeros((2, 8)), [8, 8], [1.5, 2], [1, -1], device="cpu")
    assert [t.dtype for t in batch] == [torch.int16, torch.int32, torch.float32, torch.int8]
    assert set(tchain.CHAIN_OUT_KEYS) | set(tchain.CHAIN_OVERFLOW_KEYS) == set(
        chain_scan_cuda(*batch, tcfg))
    assert tchain.CHAIN_STATS_KEYS == jchain.CHAIN_STATS_KEYS


def _bench_batch(n):
    return (make_batch(n, 256, seed=0), np.full(n, 256, np.int32),
            np.full(n, 1000.0, np.float32), np.full(n, 1, np.int8))


def test_main_path_workload_matches_jax():
    """bench.py's config on make_batch(8192, 256, seed=0), overflow included."""
    ref = _compare(BENCH_CFG, *_bench_batch(8192))
    assert int(ref["n_peak_overflow"]) > 0  # noisy pulse tops overflow max_peaks=8


def test_smoke_reference_counts():
    """The seed-0 65536-event counts chip_smoke.py asserts, from JAX."""
    import chip_smoke

    jcfg, tcfg = _configs(**BENCH_CFG)
    waves, el, bl, pol = _bench_batch(65536)
    ref = jchain.full_chain_step(jnp.asarray(waves), jnp.asarray(el), jnp.asarray(bl),
                                 jnp.asarray(pol), jcfg)
    label = np.asarray(ref["label"])
    counts = (int(np.sum(label[0::2] == 1)), int(np.sum(label[1::2] == 2)),
              int(ref["n_peak_overflow"]), int(ref["n_hit_overflow"]))
    assert counts == (chip_smoke.REF_S1_EVEN, chip_smoke.REF_S2_ODD,
                      chip_smoke.REF_PEAK_OVERFLOW, chip_smoke.REF_HIT_OVERFLOW)
