"""The find_peaks kernel (K2) and the width-crossing kernel (K4) on the card.

Both are warp-per-event kernels on the event-major rows. The test holds
each against its plain PyTorch version on the same CUDA tensors, in every
row layout the wrappers can pick: 16-byte and element row copies (L = 255
and 250), rows read from global memory (the long-row mode), and K = 1, 32
and, for K4, 40 slots. Tolerance:
integer, index, count and validity outputs exact; float32 outputs atol
1e-3 / rtol 1e-4, K2's slot values where the slot is valid (the contract,
as in tests/test_torch_scan_kernels.py). The file imports no JAX, so it
runs on a machine without it:
``python -m pytest --noconftest -q -m cuda tests/test_torch_scan_kernels_cuda.py``.
The batch makers are shared with tests/test_torch_scan_kernels.py.
"""

import numpy as np
import pytest
import torch

ATOL, RTOL = 1e-3, 1e-4
PEAK_SLOT_FIELDS = ("peak_value", "prominence", "left_ips", "right_ips", "widths",
                    "left_bases", "right_bases")
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
