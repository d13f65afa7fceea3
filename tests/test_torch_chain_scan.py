"""The port's fused chain against the JAX package on the CPU.

``full_chain_step`` of the port and ``chain_scan_cuda`` on CPU tensors (its
plain path) against the JAX XLA chain ``full_chain_step``, on the cases
tests/test_chain_scan_pallas.py holds the Pallas kernel to, plus one case
against the Pallas kernel itself in interpret mode and bench.py's workload.
Tolerance: integer, index, count, validity and label outputs exact; float32
outputs atol 1e-3 / rtol 1e-4.
"""

import contextlib
import ctypes
import dataclasses
import logging
import sys
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bench import make_batch
from waveformanalysis_tpu.models import full_chain as jchain
from waveformanalysis_tpu_torch.models import full_chain as tchain
from waveformanalysis_tpu_torch.ops import chain_scan_cuda as csc
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


class _StubChainLibrary:
    """Stands in for the chain kernel's library: records each launch and
    writes through the output struct as the kernel would: the first height,
    the last label and both counters."""

    PEAK_OVERFLOW, HIT_OVERFLOW = 3, 5

    def __init__(self):
        self.calls = []
        self.switches = 0  # torch.cuda.device entries

    def _write(self, outs, n):
        o = outs._obj
        ctypes.c_float.from_address(o.height).value = 1.5
        ctypes.c_int8.from_address(o.label + n - 1).value = 2
        ctypes.c_int32.from_address(o.n_peak_overflow).value = self.PEAK_OVERFLOW
        ctypes.c_int32.from_address(o.n_hit_overflow).value = self.HIT_OVERFLOW

    def wfa_chain_scan(self, w, el, bl, pol, outs, prm, rows, vec, stream):
        self.calls.append(dict(path="staged", L=prm._obj.L, rows=rows, vec=vec))
        self._write(outs, prm._obj.n)
        return 0

    def wfa_chain_scan_regs(self, w, el, bl, pol, outs, prm, rows, R, vec, smem, stream):
        self.calls.append(dict(path="register", L=prm._obj.L, rows=rows, vec=vec, R=R,
                               smem=smem, deriv=prm._obj.use_derivative))
        self._write(outs, prm._obj.n)
        return 0


@pytest.fixture
def stub_chain_launch(monkeypatch):
    """chain_scan_cuda on CPU tensors posing as CUDA tensors on the current
    device, its library and stream stubbed: no build, no card; an empty
    plan cache."""

    @contextlib.contextmanager
    def device(dev):
        lib.switches += 1
        yield

    lib = _StubChainLibrary()
    monkeypatch.setattr(csc, "_library", lambda: lib)
    monkeypatch.setattr(csc, "_devices", lambda *ts: "cuda")
    monkeypatch.setattr(csc, "_PLANS", {})
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)  # a CPU tensor's index
    monkeypatch.setattr(csc, "_stream", lambda dev: 0)
    return lib


def _zero_batch(n, length):
    return (torch.zeros((n, length), dtype=torch.int16), torch.full((n,), length, dtype=torch.int32),
            torch.zeros(n), torch.ones(n, dtype=torch.int8))


@pytest.mark.parametrize("length,samples", [(2, 1), (31, 1), (32, 1), (33, 2), (255, 8),
                                            (256, 8), (257, 0), (1000, 0)])
def test_chain_wrapper_picks_the_path_by_length(stub_chain_launch, length, samples):
    """Rows of L <= 256 take the register path with R = ceil(L / 32)
    rounded up to 1, 2, 4 or 8 samples a lane, longer rows the staged path;
    the wrapper passes each path's events per block (4 and 8) and shared
    memory: on the register path 32 R float32 samples a warp (twice with
    the derivative signal) and the four 32-entry slot tables, on the staged
    path row_layout's int16 row and slot tables."""
    for deriv in (False, True):
        batch = _zero_batch(6, length)
        chain_scan_cuda(*batch, tchain.ChainConfig(use_derivative=deriv))
        call = stub_chain_launch.calls[-1]
        vec = int(length % 8 == 0 and batch[0].data_ptr() % 16 == 0)
        rows = 4 if samples else 8
        assert call["L"] == length and call["rows"] == rows and call["vec"] == vec
        lay = csc.chain_layout(length, batch[0].data_ptr(), deriv)
        assert (lay.path, lay.R, lay.rows, lay.vec) == (call["path"], samples, rows, bool(vec))
        if samples:
            assert call["path"] == "register" and call["R"] == samples
            assert call["deriv"] == int(deriv)
            assert call["smem"] == lay.smem_bytes == 4 * (
                128 * samples * (2 if deriv else 1) + 512)
        else:
            assert call["path"] == "staged"
            assert lay.smem_bytes == csc.row_layout(
                length, 2, batch[0].data_ptr(), csc.CHAIN_SLOT_BYTES).smem_bytes == 8 * (
                csc.row_bytes(length, 2) + 512)


def _counts():
    fn = chain_scan_cuda
    return (fn.launches, fn.register_launches, fn.staged_launches, fn.plan_hits,
            fn.plan_misses)


def test_chain_wrapper_counts_launches_by_path(stub_chain_launch):
    """register_launches and staged_launches count one launch each beside
    launches; an empty batch calls no library, counts nothing and returns
    no events with both counters 0."""
    before = _counts()
    chain_scan_cuda(*_zero_batch(4, 256))
    assert _counts()[:3] == (before[0] + 1, before[1] + 1, before[2])
    chain_scan_cuda(*_zero_batch(4, 300))
    assert _counts()[:3] == (before[0] + 2, before[1] + 1, before[2] + 1)
    after = _counts()
    for length in (256, 300):
        out = chain_scan_cuda(*_zero_batch(0, length))
        assert out["label"].shape == (0,) and list(out) == list(_reference(0, length))
        assert int(out["n_peak_overflow"]) == int(out["n_hit_overflow"]) == 0
    assert _counts() == after
    assert [c["path"] for c in stub_chain_launch.calls] == ["register", "staged"]


def _reference(n, length, cfg=None):
    return tchain.full_chain_step(*_zero_batch(n, length), cfg or tchain.ChainConfig())


@pytest.mark.parametrize("length", [256, 300])
def test_chain_wrapper_one_call_one_allocation(stub_chain_launch, length):
    """On both paths a call makes one library call and returns
    full_chain_step's keys, dtypes and shapes (the counters 0-d int32), all
    views of one fresh allocation, disjoint, at the addresses the output
    struct hands the kernel; a second call's storage is another."""
    cfg = tchain.ChainConfig(use_derivative=False)
    ref = _reference(6, length, cfg)
    step = make_chain_scan(cfg)
    batch = _zero_batch(6, length)
    first = step(*batch)
    second = step(*batch)
    assert len(stub_chain_launch.calls) == 2
    for out in (first, second):
        assert list(out) == list(ref)
        for k, v in ref.items():
            assert out[k].dtype == v.dtype and out[k].shape == v.shape, k
        assert out["n_peak_overflow"].shape == () and out["n_hit_overflow"].shape == ()
        assert (int(out["n_peak_overflow"]), int(out["n_hit_overflow"])) == (
            _StubChainLibrary.PEAK_OVERFLOW, _StubChainLibrary.HIT_OVERFLOW)
        assert float(out["height"][0]) == 1.5 and int(out["label"][-1]) == 2
        assert len({t.untyped_storage().data_ptr() for t in out.values()}) == 1
        spans = sorted((t.data_ptr(), t.data_ptr() + t.nbytes) for t in out.values())
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert (first["label"].untyped_storage().data_ptr()
            != second["label"].untyped_storage().data_ptr())


def test_chain_wrapper_plans_under_threads(stub_chain_launch, monkeypatch):
    """16 threads launch through one step function over 20 batch shapes,
    more than the cores, with a short switch interval and a cache that
    fills and starts afresh: every call returns its own outputs and counts
    one launch, which is a plan hit or a plan miss."""
    monkeypatch.setattr(csc, "MAX_PLANS", 8)
    step = make_chain_scan(tchain.ChainConfig(use_derivative=False))
    batches = [_zero_batch(n, 256) for n in range(4, 24)]
    errors = []

    def work(k):
        try:
            for i in range(40):
                n = 4 + (k + i) % 20
                out = step(*batches[n - 4])
                assert out["label"].shape == (n,) and int(out["n_hit_overflow"]) == 5
        except Exception as exc:  # reported below, with the thread's index
            errors.append((k, exc))

    before = _counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    after = _counts()
    assert after[0] - before[0] == 16 * 40 == len(stub_chain_launch.calls)
    assert (after[3] - before[3]) + (after[4] - before[4]) == 16 * 40
    assert len(csc._PLANS) <= 8


def test_chain_wrapper_counts_plan_hits_and_misses(stub_chain_launch, monkeypatch):
    """The launch plan is kept by device, n, L, the rows' 16-byte alignment
    and the config object: a repeat hits; another n, L, alignment or config
    misses, with the layout of its own; the device is switched only where
    it is not the current one."""
    cfg = tchain.ChainConfig(use_derivative=False)
    step = make_chain_scan(cfg)
    before = _counts()
    step(*_zero_batch(8, 256))
    step(*_zero_batch(8, 256))
    step(*_zero_batch(16, 256))
    step(*_zero_batch(8, 250))
    chain_scan_cuda(*_zero_batch(8, 256), tchain.ChainConfig(use_derivative=False))
    w, el, bl, pol = _zero_batch(8, 256)
    buf = torch.zeros(8 * 256 + 8, dtype=torch.int16)
    unaligned = buf[1:1 + 8 * 256].view(8, 256)  # 2 bytes past the base
    step(unaligned, el, bl, pol)
    step(*_zero_batch(8, 256))
    after = _counts()
    assert (after[0] - before[0], after[3] - before[3], after[4] - before[4]) == (7, 2, 5)
    assert [c["vec"] for c in stub_chain_launch.calls] == [1, 1, 1, 0, 1, 0, 1]
    assert [c["L"] for c in stub_chain_launch.calls] == [256, 256, 256, 250, 256, 256, 256]
    assert stub_chain_launch.switches == 0
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    step(*_zero_batch(8, 256))
    assert stub_chain_launch.switches == 1 and _counts()[3] == after[3] + 1
