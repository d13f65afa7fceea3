"""The hand-written kernels on the card: the chains (K1, K7), find_peaks
(K2), threshold hits (K3), width crossings (K4) and the zero-phase
Butterworth filter (K5), and the memory a CUDA Context holds across route-B
requests.

K2, K3 and K4 are held against their plain PyTorch versions on the same
CUDA tensors in every row layout the wrappers can pick: 16-byte and element
row copies (L = 256 or 255, and 250), rows read from global memory (the
long-row mode), and K = 1, 8, 32 and 40 slots (K3 and K4 in chunks of 32).
K1 and K7 are held against ``full_chain_step`` and against each other's
integer outputs. K5 is held bit for bit against ``sosfiltfilt_plain``.
Tolerance otherwise: integer, index, count, validity and label outputs
exact; float32 outputs atol 1e-3 / rtol 1e-4, slot values where the slot is
valid (the contract, as in tests/test_torch_scan_kernels.py). The
file imports no JAX, so it runs on a machine without it:
``python -m pytest --noconftest -q -m cuda tests/test_torch_scan_kernels_cuda.py``.
The batch makers are shared with tests/test_torch_scan_kernels.py.
"""

import numpy as np
import pytest
import torch

ATOL, RTOL = 1e-3, 1e-4
PEAK_SLOT_FIELDS = ("peak_value", "prominence", "left_ips", "right_ips", "widths",
                    "left_bases", "right_bases")
HIT_SLOT_FIELDS = ("position", "height", "integral", "seg_start", "seg_end",
                   "run_start", "run_end")
FRACS = (0.1, 0.9, 0.9, 0.1)


def tie_batch(n, L, seed):
    """int16 pulses on a 1000 baseline, quantised to steps of 8 so equal
    samples are everywhere (plateaus at the tops, equal minima on both
    sides of a peak); every fourth event pure noise; ragged valid lengths."""
    rng = np.random.default_rng(seed)
    t = np.arange(L)
    w = np.full((n, L), 1000.0)
    for _ in range(3):
        c = rng.integers(4, L - 4, n)
        amp = rng.choice([0.0, 60.0, 120.0, 240.0], n) * (np.arange(n) % 4 != 3)
        w += amp[:, None] * np.exp(-((t - c[:, None]) ** 2)
                                   / (2 * rng.uniform(1, 8, n)[:, None] ** 2))
    w += rng.normal(0, 6, w.shape)
    w = np.round(w / 8) * 8
    return w.astype(np.int16), rng.integers(L // 2, L + 1, n).astype(np.int32)


def screen_batch(n, L, seed):
    """int16 rows of L >= 200 samples on a 1000 baseline on which K1's
    prominence screen engages (two kept slots or more): even rows two linear
    peaks, the lower one (85 to 139 high) 12 to L / 4 samples left or right
    of the higher one (150 to 299), with the valley between them set so that
    the lower peak's bound, and its prominence, is 49, 50 or 51 against the
    bench config's 50; odd rows bench.py's wide pulse (sigma 25, 250 high,
    noise sigma 2), whose noisy top holds several kept slots short of the
    prominence."""
    rng = np.random.default_rng(seed)
    t = np.arange(L)
    w = np.empty((n, L))
    for i in range(n):
        if i % 2:
            c = rng.integers(60, L - 60)
            w[i] = 1000 + 250 * np.exp(-(t - c) ** 2 / (2 * 25.0 ** 2)) + rng.normal(0, 2, L)
            continue
        v_hi, v_lo = rng.integers(150, 300), rng.integers(85, 140)
        p_hi = rng.integers(L // 4, 3 * L // 4)
        p_lo = p_hi + rng.integers(12, L // 4) * rng.choice([-1, 1])
        valley = v_lo - 50 + rng.integers(-1, 2)
        knots = sorted([(p_hi, v_hi), (p_lo, v_lo), ((p_hi + p_lo) // 2, valley),
                        (min(p_hi, p_lo) - 20, 0), (max(p_hi, p_lo) + 20, 0)])
        w[i] = 1000 + np.interp(t, *zip(*knots), left=0, right=0)
    return np.round(w).astype(np.int16), np.full(n, L, np.int32)


def peak_cases():
    """(tag, signal float32 (n, L), valid length, find_peaks keywords)."""
    w, vl = tie_batch(64, 64, seed=21)
    sig = w.astype(np.float32) - 1000.0
    kw = dict(height=8.0, prominence=8.0, width=1.0, max_peaks=32)
    return [
        ("ties_k32_d1", sig, vl, dict(kw, distance=1)),
        ("ties_k32_d3", sig, vl, dict(kw, distance=3)),
        ("ties_k1_d2", sig, vl, dict(kw, distance=2, max_peaks=1)),
    ]


def hit_batch(n, L, seed):
    """float32 signals for the threshold-run kernel, one kind of event in
    turn: noisy pulses; one run over the whole row; a comb of many short
    runs; runs that straddle the 32-sample steps; a run still open at the
    valid length. Thresholds per event; ragged valid lengths, some on a
    multiple of 32."""
    rng = np.random.default_rng(seed)
    t = np.arange(L)
    x = rng.normal(0, 12, (n, L))
    vl = rng.integers(L // 2, L + 1, n)
    vl[::7] = (vl[::7] // 32) * 32
    for i in range(n):
        kind = i % 5
        if kind == 0:
            for c in rng.integers(8, L - 8, 3):
                x[i] += 150 * np.exp(-((t - c) ** 2) / (2 * rng.uniform(1, 12) ** 2))
        elif kind == 1:
            x[i] += 200
        elif kind == 2:
            x[i, :: rng.integers(2, 5)] += 200
        elif kind == 3:
            for b in range(32, L, 32):
                x[i, b - rng.integers(1, 4): b + rng.integers(1, 4)] += 200
        else:
            x[i, max(vl[i] - rng.integers(1, 40), 0):] += 200
    thr = rng.uniform(30, 60, n)
    return x.astype(np.float32), thr.astype(np.float32), vl.astype(np.int32)


def hit_cases():
    """(tag, signal float32 (n, L), thresholds, valid length, keywords)."""
    x, thr, vl = hit_batch(60, 256, seed=31)
    x250, thr250, vl250 = hit_batch(60, 250, seed=32)
    kw = dict(left_extension=2, right_extension=2)
    return [
        ("mixed_k8", x, thr, vl, dict(kw, max_hits=8)),
        ("mixed_k1", x, thr, vl, dict(kw, max_hits=1)),
        ("mixed_k32_ext0_5", x, thr, vl, dict(left_extension=0, right_extension=5,
                                                max_hits=32)),
        ("mixed_k40", x, thr, vl, dict(kw, max_hits=40)),
        ("unaligned_250_k8", x250, thr250, vl250, dict(kw, max_hits=8)),
        ("full_length_k32", x, thr, np.full_like(vl, 256), dict(kw, max_hits=32)),
    ]


def _same(ref, out, tag, mask=None, masked=()):
    assert list(out) == list(ref), tag
    for k in ref:
        a, b = ref[k].cpu().numpy(), out[k].cpu().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (tag, k, a.dtype, b.dtype)
        if k in masked:
            a, b = a[mask], b[mask]
        if np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(b, a, atol=ATOL, rtol=RTOL, err_msg=f"{tag}/{k}")
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{tag}/{k}")


@pytest.mark.cuda
def test_peaks_and_width_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    from waveformanalysis_tpu_torch.ops import chain_scan_cuda as csc
    from waveformanalysis_tpu_torch.ops import width_scan_cuda as wsc
    from waveformanalysis_tpu_torch.ops.peaks import find_peaks_batch

    dev = torch.device("cuda")
    w, vl = tie_batch(1003, 256, seed=5)
    sig = torch.from_numpy(w).to(dev).float() - 1000.0
    vlen = torch.from_numpy(vl).to(dev)
    long_w, long_vl = tie_batch(3, 65_536, seed=6)  # 256 KB rows: read from global memory
    kw = dict(height=16.0, prominence=8.0, width=1.0, max_peaks=32)
    cases = [(tag, torch.from_numpy(s).to(dev), torch.from_numpy(v).to(dev), k)
             for tag, s, v, k in peak_cases()] + [
        ("k32_d2", sig, vlen, dict(kw, distance=2)),
        ("derivative_255", sig[:, 1:] - sig[:, :-1], (vlen - 1).clamp(min=0),
         dict(kw, height=8.0, prominence=4.0, distance=3)),
        ("unaligned_250", sig[:, :250].contiguous(), vlen.clamp(max=250), dict(kw, distance=1)),
        ("long_rows", torch.from_numpy(long_w).to(dev).float() - 1000.0,
         torch.from_numpy(long_vl).to(dev), dict(kw, distance=2)),
    ]
    for tag, s, v, k in cases:
        before = csc.find_peaks_scan.launches
        out = csc.find_peaks_scan(s, valid_length=v, **k)
        torch.cuda.synchronize()
        assert csc.find_peaks_scan.launches == before + 1
        ref = find_peaks_batch(s, valid_length=v, **k)
        _same(ref, out, f"K2 {tag}", ref["valid"].cpu().numpy(), PEAK_SLOT_FIELDS)

    pos = csc.find_peaks_scan(sig, valid_length=vlen, **dict(kw, distance=2))["position"]
    bl = torch.from_numpy(w).to(dev).float()[:, :50].sum(dim=1) / 50
    wl = torch.from_numpy(tie_batch(3, 65_536, seed=7)[0]).to(dev)
    rng = np.random.default_rng(8)
    odd = torch.from_numpy(rng.integers(-3, 259, (1003, 40)).astype(np.int32)).to(dev)
    long_pos = torch.tensor([[5, 30_000, 65_535, -1]] * 3, dtype=torch.int32, device=dev)
    long_bl = torch.full((3,), 1000.0, device=dev)
    width_cases = [
        ("int16_k32", torch.from_numpy(w).to(dev), bl, pos, True),
        ("f32_k32_no_interp", sig + 1000.0, bl, pos, False),
        ("int16_unaligned_250_k1", torch.from_numpy(w[:, :250].copy()).to(dev), bl,
         pos[:, :1].clamp(max=249).contiguous(), True),
        ("f32_k40_odd_positions", sig + 1000.0, bl, odd, True),
        ("all_empty", torch.from_numpy(w).to(dev), bl, torch.full_like(pos, -1), True),
        ("int16_65536", wl, long_bl, long_pos, True),
        ("f32_65536_long_rows", wl.float(), long_bl, long_pos, True),
    ]
    for tag, wv, b, p, interp in width_cases:
        before = wsc.width_crossings_scan.launches
        out = wsc.width_crossings_scan(wv, b, p, *FRACS, interp)
        torch.cuda.synchronize()
        assert wsc.width_crossings_scan.launches == before + 1
        _same(wsc.width_crossings_plain(wv, b, p, *FRACS, interp), out, f"K4 {tag}")


@pytest.mark.cuda
def test_hits_kernel_matches_plain_on_card():
    """K3 in each row layout: 16-byte row copies (L = 256), element copies
    (L = 250), rows read from global memory (65,536 f32 samples), with
    K = 1, 8, 32 and 40 (two chunks of slots)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    from waveformanalysis_tpu_torch.ops import chain_scan_cuda as csc
    from waveformanalysis_tpu_torch.ops.hits import threshold_hits_batch

    dev = torch.device("cuda")
    long_x, long_thr, _ = hit_batch(5, 65_536, seed=33)
    long_vl = np.array([65_536, 40_000, 65_535, 31, 0], np.int32)
    cases = hit_cases() + [("long_rows_k32", long_x, long_thr, long_vl,
                            dict(left_extension=2, right_extension=2, max_hits=32))]
    layouts = set()
    for tag, x, thr, vl, kw in cases:
        s, t, v = (torch.from_numpy(a).to(dev) for a in (x, thr, vl))
        lay = csc.row_layout(s.shape[1], 4, s.data_ptr(), csc.HIT_SLOT_BYTES)
        layouts.add((lay.staged, lay.vec))
        before = csc.threshold_hits_scan.launches
        out = csc.threshold_hits_scan(s, t, v, **kw)
        torch.cuda.synchronize()
        assert csc.threshold_hits_scan.launches == before + 1
        ref = threshold_hits_batch(s, t, v, **kw)
        _same(ref, out, f"K3 {tag}", ref["valid"].cpu().numpy(), HIT_SLOT_FIELDS)
    assert layouts == {(True, True), (True, False), (False, False)}


@pytest.mark.cuda
def test_chain_kernel_matches_plain_and_tile_on_card():
    """K1 against full_chain_step (integers exact, f32 atol 1e-3 / rtol
    1e-4) and against K7's integer outputs, on tie-heavy int16 waves with
    ragged lengths and mixed polarity: the bench config, the derivative
    signal at K = 32, dense slots at distance 2; on the register path at L =
    256 (16-byte row loads), 250, 33 and 31 and with the rows at an
    unaligned base (element loads), on the staged path at L = 257. The f32
    sums of the two paths (hit_integral, the width baseline) are in
    different orders: within the tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    from waveformanalysis_tpu_torch.models.full_chain import ChainConfig, full_chain_step
    from waveformanalysis_tpu_torch.ops import chain_scan_cuda as csc
    from waveformanalysis_tpu_torch.ops import chain_tile_cuda as ctc

    dev = torch.device("cuda")
    rng = np.random.default_rng(9)
    cfgs = {
        "bench": ChainConfig(use_derivative=False, peak_height=80.0, peak_prominence=50.0,
                             peak_width=2.0),
        "derivative_k32": ChainConfig(use_derivative=True, peak_height=8.0,
                                      peak_prominence=4.0, peak_width=1.0, peak_distance=3,
                                      max_peaks=32, max_hits=32),
        "dense_k32_d2": ChainConfig(use_derivative=False, peak_height=8.0,
                                    peak_prominence=4.0, peak_width=0.5, peak_distance=2,
                                    max_peaks=32, max_hits=32, hit_threshold=8.0),
    }
    paths = set()
    for L, unaligned in ((256, False), (250, False), (257, False), (33, False), (31, False),
                         (256, True)):
        w, vl = tie_batch(1003, L, seed=10 + L)
        bl = (1000 + rng.integers(-3, 4, 1003)).astype(np.float32)
        pol = rng.choice(np.array([-1, 0, 1], np.int8), 1003)
        pol[::4] = 1
        batch = tuple(torch.from_numpy(a).to(dev) for a in (w, vl, bl, pol))
        if unaligned:  # the same rows one int16 past a 16-byte boundary
            buf = torch.empty(w.size + 8, dtype=torch.int16, device=dev)
            waves = buf[1:1 + w.size].view(w.shape)
            waves.copy_(batch[0])
            batch = (waves,) + batch[1:]
        lay = csc.chain_layout(L, batch[0].data_ptr(), False)
        assert lay.vec == (L % 8 == 0 and not unaligned)
        paths.add((lay.path, lay.vec))
        for tag, cfg in cfgs.items():
            before = (csc.chain_scan_cuda.launches, csc.chain_scan_cuda.register_launches,
                      csc.chain_scan_cuda.staged_launches)
            out = csc.chain_scan_cuda(*batch, cfg)
            torch.cuda.synchronize()
            reg = lay.path == "register"
            assert (csc.chain_scan_cuda.launches, csc.chain_scan_cuda.register_launches,
                    csc.chain_scan_cuda.staged_launches) == (
                before[0] + 1, before[1] + reg, before[2] + (not reg))
            ref = full_chain_step(*batch, cfg)
            _same(ref, out, f"K1 {tag} L={L} unaligned={unaligned}")
            tile = ctc.chain_tile_cuda(*batch, cfg)
            for k, v in ref.items():
                if not v.dtype.is_floating_point:
                    assert torch.equal(out[k], tile[k]), f"K1 != K7: {tag} L={L} {k}"
    assert paths == {("register", True), ("register", False), ("staged", False)}


@pytest.mark.cuda
def test_chain_kernel_bit_equal_to_tile_on_bench_waves_on_card():
    """K1 (the register path) and K7 (the staged float row) give all 14
    outputs bit for bit on the benchmark's waves at 65,536 x 256 (integer
    samples on an integer baseline: the f32 sums are exact in any order),
    with the benchmark's config."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    from portbench.gen import generator, make_batch
    from waveformanalysis_tpu_torch.models.full_chain import ChainConfig
    from waveformanalysis_tpu_torch.ops import chain_scan_cuda as csc
    from waveformanalysis_tpu_torch.ops import chain_tile_cuda as ctc

    dev = torch.device("cuda")
    n, L = 65_536, 256
    cfg = ChainConfig(use_derivative=False, peak_height=80.0, peak_prominence=50.0,
                      peak_width=2.0)
    batch = (make_batch(n, L, generator(2_718_281_828, dev)),
             torch.full((n,), L, dtype=torch.int32, device=dev),
             torch.full((n,), 1000.0, device=dev), torch.ones(n, dtype=torch.int8, device=dev))
    assert csc.chain_layout(L, batch[0].data_ptr(), False).path == "register"
    out = csc.chain_scan_cuda(*batch, cfg)
    tile = ctc.chain_tile_cuda(*batch, cfg)
    torch.cuda.synchronize()
    assert list(out) == list(tile) and len(out) == 14
    for k in out:
        assert torch.equal(out[k], tile[k]), k
    labels = out["label"].cpu().numpy()
    assert (labels[0::2] == 1).mean() > 0.9 and (labels[1::2] == 2).mean() > 0.9


@pytest.mark.cuda
def test_chain_screen_rows_match_plain_and_tile_on_card():
    """K1 on rows where its prominence screen engages on nearly every row
    and a third of the lower peaks' bounds sit exactly at the prominence
    (screen_batch), at L = 256 (16-byte row loads) and 250 (element loads),
    with the bench config: against full_chain_step (integers exact, f32 atol
    1e-3 / rtol 1e-4) and K7's integer outputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    from waveformanalysis_tpu_torch.models.full_chain import ChainConfig, full_chain_step
    from waveformanalysis_tpu_torch.ops import chain_scan_cuda as csc
    from waveformanalysis_tpu_torch.ops import chain_tile_cuda as ctc

    dev = torch.device("cuda")
    cfg = ChainConfig(use_derivative=False, peak_height=80.0, peak_prominence=50.0,
                      peak_width=2.0)
    for L in (256, 250):
        w, vl = screen_batch(8_192, L, seed=24 + L)
        n = len(w)
        batch = (torch.from_numpy(w).to(dev), torch.from_numpy(vl).to(dev),
                 torch.full((n,), 1000.0, device=dev), torch.ones(n, dtype=torch.int8, device=dev))
        lay = csc.chain_layout(L, batch[0].data_ptr(), False)
        assert (lay.path, lay.R, lay.vec) == ("register", 8, L == 256)
        out = csc.chain_scan_cuda(*batch, cfg)
        torch.cuda.synchronize()
        ref = full_chain_step(*batch, cfg)
        _same(ref, out, f"K1 screen rows L={L}")
        tile = ctc.chain_tile_cuda(*batch, cfg)
        for k, v in ref.items():
            if not v.dtype.is_floating_point:
                assert torch.equal(out[k], tile[k]), f"K1 != K7: screen rows L={L} {k}"
        peaks = ref["n_peaks"][0::2].cpu()
        assert bool((peaks == 1).any()) and bool((peaks == 2).any())


@pytest.mark.cuda
def test_tile_chain_matches_plain_and_scan_chain_on_card():
    """K7 against full_chain_step and K1's integer outputs at K = 8 and
    K = 32 with distance 2, on tie-heavy int16 waves with ragged lengths and
    mixed polarity, L = 256 and 250 (the float32 signal row), 1,500 (the
    int16 row: the float row would leave fewer warps an SM) and 40,000 (too
    long for the float row), 3..32 events per block."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    from waveformanalysis_tpu_torch.models.full_chain import ChainConfig, full_chain_step
    from waveformanalysis_tpu_torch.ops import chain_scan_cuda as csc
    from waveformanalysis_tpu_torch.ops import chain_tile_cuda as ctc

    dev = torch.device("cuda")
    rng = np.random.default_rng(12)
    cfgs = {
        "k8_d2": ChainConfig(use_derivative=False, peak_height=16.0, peak_prominence=8.0,
                             peak_width=1.0, peak_distance=2),
        "k32_d2": ChainConfig(use_derivative=False, peak_height=8.0, peak_prominence=4.0,
                              peak_width=0.5, peak_distance=2, max_peaks=32, max_hits=32,
                              hit_threshold=8.0),
        "derivative_k32_d2": ChainConfig(use_derivative=True, peak_height=8.0,
                                         peak_prominence=4.0, peak_width=1.0, peak_distance=2,
                                         max_peaks=32, max_hits=32),
    }
    # L = 1,500 and 40,000: K7 keeps the int16 row alone
    for L, tile_rows, n in ((256, 8, 1003), (250, 3, 1003), (256, 32, 1003), (1_500, 8, 203),
                            (40_000, 8, 37)):
        assert ctc.tile_layout(L, tile_rows).float_row == (L < 1_000)
        w, vl = tie_batch(n, L, seed=20 + L + tile_rows)
        bl = (1000 + rng.integers(-3, 4, n)).astype(np.float32)
        pol = rng.choice(np.array([-1, 0, 1], np.int8), n)
        batch = tuple(torch.from_numpy(a).to(dev) for a in (w, vl, bl, pol))
        for tag, cfg in cfgs.items():
            before = ctc.chain_tile_cuda.launches
            out = ctc.chain_tile_cuda(*batch, cfg, tile_rows=tile_rows)
            torch.cuda.synchronize()
            assert ctc.chain_tile_cuda.launches == before + 1
            ref = full_chain_step(*batch, cfg)
            _same(ref, out, f"K7 {tag} L={L} rows={tile_rows}")
            k1 = csc.chain_scan_cuda(*batch, cfg)
            for k, v in ref.items():
                if not v.dtype.is_floating_point:
                    assert torch.equal(out[k], k1[k]), f"K7 != K1: {tag} L={L} {k}"


def comb_batch(n, L, period, seed):
    """int16 combs on a 1000 baseline with +-2 noise: one pulse shape of
    height 240-360 every ``period`` samples from a random phase. With the
    bench config (8 peak and 8 hit slots) every event overflows both at
    period 8 and none does at period 64."""
    rng = np.random.default_rng(seed)
    shape = np.array([0, 100, 250, 300, 250, 100, 0, 0], float)
    t = np.arange(L)[None, :] + rng.integers(0, period, n)[:, None]
    pulse = np.where(t % period < 8, shape[np.minimum(t % period, 7)], 0.0)
    w = 1000 + pulse * rng.uniform(0.8, 1.2, n)[:, None] + rng.integers(-2, 3, (n, L))
    return (w.astype(np.int16), np.full(n, L, np.int32), np.full(n, 1000.0, np.float32),
            np.ones(n, np.int8))


@pytest.mark.cuda
def test_chain_overflow_counters_equal_plain_on_card():
    """K1 on the register path (L = 256) and the staged path (L = 300), and
    K7, count both overflows in the kernel: 0-d int32 counters on the card,
    equal to full_chain_step's exactly on a batch where every event
    overflows and on one where none does, on every call (the C entry zeroes
    them first); the per-event outputs as the other tests hold them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    from waveformanalysis_tpu_torch.models.full_chain import (
        CHAIN_OVERFLOW_KEYS,
        ChainConfig,
        full_chain_step,
    )
    from waveformanalysis_tpu_torch.ops import chain_scan_cuda as csc
    from waveformanalysis_tpu_torch.ops import chain_tile_cuda as ctc

    dev = torch.device("cuda")
    cfg = ChainConfig(use_derivative=False, peak_height=80.0, peak_prominence=50.0,
                      peak_width=2.0)
    n = 4_099
    for L, path in ((256, "register"), (300, "staged")):
        for period, expect in ((8, n), (64, 0)):
            batch = tuple(torch.from_numpy(a).to(dev) for a in comb_batch(n, L, period, L))
            assert csc.chain_layout(L, batch[0].data_ptr(), False).path == path
            ref = full_chain_step(*batch, cfg)
            assert [int(ref[k]) for k in CHAIN_OVERFLOW_KEYS] == [expect, expect]
            for name, fn in (("K1", csc.chain_scan_cuda), ("K1", csc.chain_scan_cuda),
                             ("K7", ctc.chain_tile_cuda)):
                out = fn(*batch, cfg)
                torch.cuda.synchronize()
                for k in CHAIN_OVERFLOW_KEYS:
                    assert out[k].shape == () and out[k].dtype == torch.int32, (name, k)
                    assert out[k].device.type == "cuda", (name, k)
                    assert int(out[k]) == expect, (name, L, period, k, int(out[k]))
                _same(ref, out, f"{name} comb L={L} period={period}")


@pytest.mark.cuda
def test_chain_steps_do_not_alias_on_card():
    """Two successive K1 steps return separate storage: a step's outputs,
    counters included, stay as they were after the next step on another
    batch (callers keep earlier steps' outputs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    from waveformanalysis_tpu_torch.models.full_chain import ChainConfig
    from waveformanalysis_tpu_torch.ops import chain_scan_cuda as csc

    dev = torch.device("cuda")
    step = csc.make_chain_scan(ChainConfig(use_derivative=False, peak_height=80.0,
                                           peak_prominence=50.0, peak_width=2.0))
    combs = [tuple(torch.from_numpy(a).to(dev) for a in comb_batch(2_048, 256, period, 7))
             for period in (8, 64)]
    first = step(*combs[0])
    kept = {k: v.clone() for k, v in first.items()}
    second = step(*combs[1])
    torch.cuda.synchronize()
    assert (first["label"].untyped_storage().data_ptr()
            != second["label"].untyped_storage().data_ptr())
    for k, v in kept.items():
        assert torch.equal(first[k], v), k
    assert (int(first["n_peak_overflow"]), int(second["n_peak_overflow"])) == (2_048, 0)


def filter_batch(n, L, seed):
    """float32 waves on a 1000 ADC baseline: noise and one pulse per event
    at a random place, a few events flat (a zero after the mean removal)."""
    rng = np.random.default_rng(seed)
    t = np.arange(L)
    c = rng.integers(0, L, n)
    w = (1000.0 + rng.normal(0, 30, (n, L))
         + 200 * np.exp(-((t[None, :] - c[:, None]) ** 2) / 50.0))
    w[::17] = 1000.0
    return w.astype(np.float32)


@pytest.mark.cuda
def test_sosfiltfilt_kernel_bit_equal_to_plain_on_card():
    """K5 = sosfiltfilt_plain bit for bit: odd n (a ragged last 32-event
    block), L = 250 and 256, S = 1, 4 and 6 (two chunks of four sections),
    an int16 input (the wrapper casts), and rows too long for the
    shared-memory tile (the long-row mode)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    from waveformanalysis_tpu_torch.ops import filter_cuda as flc
    from waveformanalysis_tpu_torch.ops import filtering as flt

    dev = torch.device("cuda")
    designs = {"S1": (1, 0.01, 0.2, 0.5), "S4": (4, 0.002, 0.1, 0.5),
               "S6": (6, 0.01, 0.2, 0.5)}
    x256 = torch.from_numpy(filter_batch(1001, 256, seed=40)).to(dev)
    x250 = torch.from_numpy(filter_batch(1001, 250, seed=41)).to(dev)
    long_x = torch.from_numpy(filter_batch(67, 3000, seed=42)).to(dev)
    cases = [(f"{d}_L256", d, x256) for d in designs] + [
        (f"{d}_L250", d, x250) for d in designs] + [
        ("S4_int16", "S4", torch.round(x256).to(torch.int16)),
        ("S4_long_rows", "S4", long_x), ("S6_long_rows", "S6", long_x)]
    modes = set()
    for tag, d, x in cases:
        sos = flt.design_butterworth_sos(*designs[d])
        modes.add(flc.filter_layout(x.shape[1], flt.sosfiltfilt_padlen(sos)).staged)
        before = flc.sosfiltfilt_cuda.launches
        out = flc.sosfiltfilt_cuda(x, sos)
        torch.cuda.synchronize()
        assert flc.sosfiltfilt_cuda.launches == before + 1, tag
        ref = flt.sosfiltfilt_plain(x, sos)
        assert out.dtype == torch.float32 and out.shape == x.shape, tag
        assert torch.equal(out, ref), (tag, float((out - ref).abs().max()))
    assert modes == {True, False}


@pytest.mark.cuda
def test_route_b_memory_held_stays_flat_on_card(tmp_path):
    """Three route-B requests on a CUDA Context (65,536 x 256 waves): the
    memory allocated after each does not grow by the filtered float32
    matrix (67 MB) a run, and the cached filtered waves are a host array."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    import chip_smoke
    from bench import make_batch
    from waveformanalysis_tpu_torch.context.context import Context
    from waveformanalysis_tpu_torch.plugins.builtin import (
        basic_features, filtering, hit_finder, peak_finding, s1_s2_classifier,
        waveform_width)
    from waveformanalysis_tpu_torch.testing.fixtures import st_waveforms_from_waves

    plugins = (basic_features.BasicFeaturesPlugin, peak_finding.HitFinderPlugin,
               hit_finder.ThresholdHitPlugin, waveform_width.WaveformWidthPlugin,
               s1_s2_classifier.S1S2ClassifierPlugin, filtering.FilteredWaveformsPlugin)
    cfg, bl = chip_smoke.FILTER_ROUTES["B"]
    ctx = chip_smoke.make_route_context(Context, plugins, str(tmp_path), "cuda", cfg)
    base = make_batch(65_536, 256, seed=5)
    held = []
    for i in range(3):
        ctx.inject_data(f"r{i}", "st_waveforms",
                        st_waveforms_from_waves(base + np.int16(i), baseline=bl))
        ctx.get_data(f"r{i}", ["s1_s2", "hit_threshold"])
        ctx.flush_saves()
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_allocated())
        assert isinstance(ctx.get_data(f"r{i}", "filtered_waveforms")["wave"], np.ndarray)
    matrix = 65_536 * 256 * 4
    assert held[2] - held[0] < matrix, held


@pytest.mark.cuda
def test_sharded_steps_and_mesh_context_on_card(tmp_path):
    """On a mesh of [cuda:0] * 4: the sharded K1 and K7 steps launch once a
    shard and equal their one-device steps bit for bit (the statistics the
    sums over the one-device outputs); a mesh Context's route tables equal
    the one-device Context's, K2-K4 launching once a shard."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    import chip_smoke
    from bench import make_batch
    from waveformanalysis_tpu_torch.context.context import Context
    from waveformanalysis_tpu_torch.models.full_chain import CHAIN_OUT_KEYS, ChainConfig
    from waveformanalysis_tpu_torch.ops import chain_scan_cuda as csc
    from waveformanalysis_tpu_torch.ops import chain_tile_cuda as ctc
    from waveformanalysis_tpu_torch.ops import width_scan_cuda as wsc
    from waveformanalysis_tpu_torch.parallel.mesh import make_mesh
    from waveformanalysis_tpu_torch.testing.fixtures import st_waveforms_from_waves

    dev = torch.device("cuda:0")
    mesh = make_mesh(devices=[dev] * 4)
    cfg = ChainConfig(use_derivative=False, peak_height=80.0, peak_prominence=50.0,
                      peak_width=2.0)
    n, L = 4 * 4096, 256
    batch = (torch.from_numpy(make_batch(n, L, seed=3)).to(dev),
             torch.full((n,), L, dtype=torch.int32, device=dev),
             torch.full((n,), 1000.0, device=dev), torch.ones(n, dtype=torch.int8, device=dev))
    for wrapper, one, sharded in ((csc.chain_scan_cuda, csc.make_chain_scan(cfg),
                                   csc.make_sharded_chain_scan(mesh, cfg)),
                                  (ctc.chain_tile_cuda, ctc.make_chain_tile(cfg),
                                   ctc.make_sharded_chain_tile(mesh, cfg))):
        ref = one(*batch)
        before = wrapper.launches
        out = sharded(*batch)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 4
        for k in CHAIN_OUT_KEYS:
            assert np.array_equal(np.asarray(out[k]), ref[k].cpu().numpy()), k
        labels = ref["label"].cpu().numpy()
        assert int(out["n_s1"]) == int(np.sum(labels == 1))
        assert int(out["n_s2"]) == int(np.sum(labels == 2))
        assert np.isclose(float(out["total_area"]), float(ref["area"].sum()), rtol=1e-4)
        for k in ("n_peak_overflow", "n_hit_overflow"):
            assert int(out[k]) == int(ref[k]), k

    plugins = chip_smoke.route_plugin_classes()[:5]
    kernels = (csc.find_peaks_scan, csc.threshold_hits_scan, wsc.width_crossings_scan)
    st = st_waveforms_from_waves(make_batch(10_001, L, seed=4))
    tables = []
    for sub, m in (("one", None), ("mesh", mesh)):
        ctx = chip_smoke.make_route_context(Context, plugins, str(tmp_path / sub), "cuda")
        if m is not None:
            ctx.attach_mesh(m)
        ctx.inject_data("r", "st_waveforms", st)
        before = [k.launches for k in kernels]
        tables.append(ctx.get_data("r", list(chip_smoke.MEMBERS)))
        got = [k.launches - b for k, b in zip(kernels, before)]
        assert got == ([1, 1, 1] if m is None else [4, 4, 4]), (sub, got)
    for name in chip_smoke.MEMBERS:
        a, b = tables[0][name].to_numpy(), tables[1][name].to_numpy()
        assert len(a) == len(b) and a.dtype == b.dtype, name
        for f in a.dtype.names:
            assert np.array_equal(a[f], b[f]), f"{name}.{f}"
