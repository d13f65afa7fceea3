"""The port's filtering ops and filtered_waveforms plugin against JAX, on the CPU.

The same numpy inputs (from seeds) go through the JAX package and the port:
the host design code (bit for bit), the plain versions of the zero-phase
Butterworth kernels (K5 ``sosfiltfilt_plain``, K6 ``sosfilt_plain``, and the
two-pass composition of the K6 wrapper) against the Pallas kernels in
interpret mode, the JAX package's XLA scan and scipy in float64,
Savitzky-Golay, ``apply_filter`` / ``filter_pool``, and the
``filtered_waveforms`` plugin in a CPU Context against the JAX plugin.

Tolerances. IIR: the largest difference over the largest |reference|,
relative 5e-5 for the order-2 design and 5e-4 for higher orders and the
offset case (tests/test_filter_pallas.py's classes: float32 recursions in
different operation orders). SG and the SG plugin: rtol 1e-5 against JAX
(docs/PARITY.md's SG class), atol 2e-2 against scipy (tests/test_filtering.py).
Within the port, paths that run the same float32 operations are equal bit
for bit.
"""

import numpy as np
import pytest
import torch
from scipy.signal import savgol_filter
from scipy.signal import sosfiltfilt as scipy_sosfiltfilt

import jax.numpy as jnp

from bench import make_batch
from waveformanalysis_tpu.ops import filter_pallas as JP
from waveformanalysis_tpu.ops import filtering as JF
from waveformanalysis_tpu.plugins.builtin import filtering as jplug
from waveformanalysis_tpu.testing import fixtures as jfix
from waveformanalysis_tpu_torch.ops import filter_cuda as TC
from waveformanalysis_tpu_torch.ops import filtering as TF
from waveformanalysis_tpu_torch.plugins.builtin import filtering as tplug
from waveformanalysis_tpu_torch.testing import fixtures as tfix

# (order, lowcut, highcut, fs) in GHz
DESIGNS = {
    "order1": (1, 0.01, 0.2, 0.5),  # one section
    "order2": (2, 0.1, 0.2, 0.5),  # scripts/benchmark_suite.py config 3
    "order3": (3, 0.01, 0.15, 0.5),
    "order4": (4, 0.05, 0.22, 0.5),
    "order6": (6, 0.01, 0.2, 0.5),  # six sections: two chunks of four
    "route_b": (4, 0.002, 0.1, 0.5),
}


def _rel(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(out - ref)) / (np.max(np.abs(ref)) + 1e-12))


def _waves(n, L, seed=5, offset=0.0):
    """tests/test_filter_pallas.py's waves: noise and one pulse on 1000 ADC."""
    rng = np.random.default_rng(seed)
    t = np.arange(L)
    return (1000.0 + offset + rng.normal(0, 30, (n, L))
            + 200 * np.exp(-((t - L // 2) ** 2) / 50.0)).astype(np.float32)


# ---------------------------------------------------------------------------
# design (host numpy, shared code)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("design", sorted(DESIGNS))
def test_design_zi_padlen_equal_jax_bit_for_bit(design):
    sos_j = JF.design_butterworth_sos(*DESIGNS[design])
    sos_t = TF.design_butterworth_sos(*DESIGNS[design])
    np.testing.assert_array_equal(sos_t, sos_j)
    np.testing.assert_array_equal(TF.sosfilt_zi(sos_t), JF.sosfilt_zi(sos_j))
    assert TF.sosfiltfilt_padlen(sos_t) == JF.sosfiltfilt_padlen(sos_j)
    # the float32 constants are the Pallas kernel's (a0-normalised in f64)
    coef = TF.sos_coefficients(sos_t)
    assert coef.dtype == np.float32 and coef.shape == (sos_t.shape[0], 7)
    np.testing.assert_array_equal(coef[:, 0], np.float32(sos_t[:, 0] / sos_t[:, 3]))


@pytest.mark.parametrize("window,poly", [(5, 2), (11, 2), (11, 3), (9, 3), (21, 4)])
def test_savgol_matrices_equal_jax_bit_for_bit(window, poly):
    for a, b in zip(TF._savgol_matrices(window, poly), JF._savgol_matrices(window, poly)):
        np.testing.assert_array_equal(a, b)


def test_design_errors_equal_jax():
    bad = [(4, 0.1, 0.5, 0.5), (4, 0.2, 0.1, 0.5), (0, 0.01, 0.1, 0.5), (4, 0.0, 0.1, 0.5),
           (4, 0.01, 0.1, 0.0)]
    for args in bad:
        with pytest.raises(ValueError) as ej:
            JF.design_butterworth_sos(*args)
        with pytest.raises(ValueError) as et:
            TF.design_butterworth_sos(*args)
        assert str(et.value) == str(ej.value)


# ---------------------------------------------------------------------------
# the plain versions of K5 and K6
# ---------------------------------------------------------------------------

CASES = [  # (design, n, L, offset, relative bound)
    ("order2", 48, 256, 0.0, 5e-5),
    ("order3", 48, 256, 0.0, 5e-4),
    ("order4", 48, 256, 0.0, 5e-4),
    ("order2", 48, 256, 15000.0, 5e-4),  # DC conditioning
    ("order2", 7, 256, 0.0, 5e-5),
    ("order2", 1500, 96, 0.0, 5e-5),
    # L = 250 (rows that are no multiple of 4 samples) at S = 1, 4 and 6
    ("order1", 48, 250, 0.0, 5e-5),
    ("route_b", 48, 250, 0.0, 5e-4),
    ("order6", 48, 250, 0.0, 5e-4),
]


@pytest.mark.parametrize("design,n,L,offset,bound", CASES)
def test_sosfiltfilt_plain_against_pallas_xla_scipy(design, n, L, offset, bound):
    sos = TF.design_butterworth_sos(*DESIGNS[design])
    waves = _waves(n, L, offset=offset)
    out = TF.sosfiltfilt_device(waves, sos, device="cpu")
    assert out.dtype == np.float32 and out.shape == waves.shape
    refs = {
        "pallas": JP.sosfiltfilt_pallas(waves, sos, interpret=True),
        "xla_scan": JF.sosfiltfilt_device(waves, sos),
        "scipy_f64": scipy_sosfiltfilt(sos, waves.astype(np.float64), axis=-1),
    }
    worst = {k: _rel(out, ref) for k, ref in refs.items()}
    print(f"{design} n={n} L={L} offset={offset}: relative {worst}")
    assert max(worst.values()) < bound, worst
    # the tensor entry on a CPU tensor is the same plain version
    np.testing.assert_array_equal(TF.sosfiltfilt(torch.from_numpy(waves), sos).numpy(), out)


def _sosfilt_case():
    """An order-3 design, 1,024 event-major rows of 120 samples (the Pallas
    kernel takes n % 1024 == 0) and a random initial state."""
    sos = TF.design_butterworth_sos(*DESIGNS["order3"])
    rng = np.random.default_rng(7)
    n, T, S = 1024, 120, sos.shape[0]
    x = rng.normal(0, 50, (n, T)).astype(np.float32)
    zi = rng.normal(0, 20, (2 * S, n)).astype(np.float32)
    return sos, x, zi


def test_sosfilt_plain_against_pallas_timemajor():
    """K6's contract: one direction over the event-major (n, T) rows, per-event
    initial state. The Pallas kernel takes the time-major (T, n) transpose
    of the same rows; its output is transposed back."""
    sos, x, zi = _sosfilt_case()
    ref = np.asarray(JP._sosfilt_pallas_timemajor(jnp.asarray(x.T.copy()), sos, jnp.asarray(zi),
                                                  True)).T
    out = TC.sosfilt_cuda(torch.from_numpy(x), sos, torch.from_numpy(zi)).numpy()
    assert out.shape == x.shape and out.dtype == np.float32
    print(f"sosfilt_plain vs Pallas: relative {_rel(out, ref):.3g}")
    assert _rel(out, ref) < 5e-5


def test_sosfilt_plain_reverse_against_pallas_on_flipped_rows():
    """K6's reverse contract: the cascade from the last sample to the first,
    each output in place of its input, = the Pallas kernel on x[:, ::-1]
    (time-major), flipped back."""
    sos, x, zi = _sosfilt_case()
    ref = np.asarray(JP._sosfilt_pallas_timemajor(jnp.asarray(x[:, ::-1].T.copy()), sos,
                                                  jnp.asarray(zi), True)).T[:, ::-1]
    out = TC.sosfilt_cuda(torch.from_numpy(x), sos, torch.from_numpy(zi), reverse=True).numpy()
    assert out.shape == x.shape and out.dtype == np.float32
    print(f"sosfilt_plain reverse vs Pallas: relative {_rel(out, ref):.3g}")
    assert _rel(out, ref) < 5e-5


@pytest.mark.parametrize("design", ["order1", "order2", "route_b", "order6"])
@pytest.mark.parametrize("n,T", [(33, 45), (7, 310), (70, 1), (5, 64)])
def test_sosfilt_plain_ragged_rows_and_reverse(design, n, T):
    """The plain K6 on ragged n and on T no multiple of K6's 32-sample chunk
    (and a one-sample row): forward = an independent float32 loop over
    numpy rows in the kernel's operation order, bit for bit; reverse = the
    forward cascade of the flipped rows, flipped back, bit for bit; the
    wrapper on CPU tensors is the plain version."""
    sos = TF.design_butterworth_sos(*DESIGNS[design])
    rng = np.random.default_rng(n * T)
    x = rng.normal(0, 50, (n, T)).astype(np.float32)
    zi = rng.normal(0, 20, (2 * sos.shape[0], n)).astype(np.float32)
    coef = TF.sos_coefficients(sos)[:, :5]
    ref = np.empty_like(x)
    z = zi.copy()
    for t in range(T):
        v = x[:, t]
        for s, (b0, b1, b2, a1, a2) in enumerate(coef):
            y = b0 * v + z[2 * s]
            z[2 * s] = (b1 * v - a1 * y) + z[2 * s + 1]
            z[2 * s + 1] = b2 * v - a2 * y
            v = y
        ref[:, t] = v
    xt, zt = torch.from_numpy(x), torch.from_numpy(zi)
    out = TF.sosfilt_plain(xt, sos, zt)
    np.testing.assert_array_equal(out.numpy(), ref)
    rev = TF.sosfilt_plain(xt, sos, zt, reverse=True)
    np.testing.assert_array_equal(
        rev.numpy(), TF.sosfilt_plain(xt.flip(1).contiguous(), sos, zt).flip(1).numpy())
    for reverse in (False, True):
        assert torch.equal(TC.sosfilt_cuda(xt, sos, zt, reverse=reverse),
                           rev if reverse else out)


def test_two_pass_path_against_pallas_two_pass():
    """The K6 wrapper's two-pass composition (reflection, K6 forward,
    reversal, K6 backward; CPU tensors run the plain K6) against the Pallas
    two-pass path, and bit for bit against the fused plain version."""
    sos = TF.design_butterworth_sos(*DESIGNS["order2"])
    waves = _waves(1024, 128, seed=8)
    padlen = TF.sosfiltfilt_padlen(sos)
    ref = np.asarray(JP._sosfiltfilt_pallas_jit(
        jnp.asarray(waves), tuple(map(tuple, sos)), tuple(map(tuple, TF.sosfilt_zi(sos))),
        padlen, True, False))
    x = torch.from_numpy(waves)
    mean, dc = TF.condition(x, sos)
    two = TC._two_pass(x - mean, dc, sos, padlen)
    assert two.shape == x.shape and two.is_contiguous()
    assert _rel(two.numpy(), ref) < 5e-5
    np.testing.assert_array_equal(two.numpy(), TF.sosfiltfilt_plain(x, sos).numpy())


def test_two_pass_path_hands_over_event_major_rows(monkeypatch):
    """The two-pass mode hands K6 the event-major (n, L + 2 padlen) rows: the
    reflection forward, then the forward output in reverse, each with its
    (2S, n) state; no (Lp, n) tensor is made and no
    transpose, permute or flip runs. Checked with a stand-in library (the
    plain K6 on the rows behind the pointers) on CPU tensors posing as CUDA
    tensors; the result is sosfiltfilt_plain's bit for bit."""
    import contextlib
    import ctypes

    from torch.utils._python_dispatch import TorchDispatchMode

    sos = TF.design_butterworth_sos(*DESIGNS["route_b"])
    padlen, S = TF.sosfiltfilt_padlen(sos), sos.shape[0]
    n, L = 40, 250
    Lp = L + 2 * padlen
    x = torch.from_numpy(_waves(n, L))
    calls, inside = [], []

    def view(ptr, shape):
        count = int(np.prod(shape))
        return torch.from_numpy(np.ctypeslib.as_array(
            (ctypes.c_float * count).from_address(ptr)).reshape(shape))

    class Lib:
        def wfa_sosfilt(self, xp, zip_, coef, yp, prm, reverse, stream):
            P = prm._obj
            calls.append(((P.n, P.L, P.S, P.padlen), reverse))
            inside.append(True)  # the stand-in's own operations are not the wrapper's
            xs, zs = view(xp, (P.n, P.L)), view(zip_, (2 * P.S, P.n))
            view(yp, (P.n, P.L))[:] = TF.sosfilt_plain(xs.clone(), sos, zs.clone(), bool(reverse))
            inside.pop()
            return 0

    class Stream:
        cuda_stream = 0

    ops = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            res = func(*args, **(kwargs or {}))
            outs = res if isinstance(res, (tuple, list)) else (res,)
            if not inside:
                ops.append((str(func), [tuple(o.shape) for o in outs
                                        if isinstance(o, torch.Tensor)]))
            return res

    monkeypatch.setattr(TC, "_library", Lib)
    monkeypatch.setattr(TC, "_devices", lambda *ts: "cuda")
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    before = TC.sosfilt_cuda.launches
    with Record():
        two = TC.sosfiltfilt_cuda(x, sos, fused=False)
    assert TC.sosfilt_cuda.launches == before + 2
    assert calls == [((n, Lp, S, 0), 0), ((n, Lp, S, 0), 1)]
    names = " ".join(name for name, _ in ops)
    assert not any(w in names for w in ("transpose", "permute", "aten.t.", "flip")), names
    assert (Lp, n) not in [sh for _, outs in ops for sh in outs]
    np.testing.assert_array_equal(two.numpy(), TF.sosfiltfilt_plain(x, sos).numpy())


def test_short_waves_pass_through_and_1d():
    sos = TF.design_butterworth_sos(*DESIGNS["order4"])
    short = np.random.default_rng(0).normal(0, 1, (3, 10)).astype(np.float32)
    for fn in (lambda w: TF.sosfiltfilt_device(w, sos, device="cpu"), lambda w: JF.sosfiltfilt_device(w, sos)):
        np.testing.assert_array_equal(fn(short), short)
    wave = _waves(1, 256)[0]
    out = TF.sosfiltfilt_device(wave, sos, device="cpu")
    assert out.shape == (256,)
    assert _rel(out, JF.sosfiltfilt_device(wave, sos)) < 5e-4
    with pytest.raises(ValueError, match="padlen"):
        TC.sosfiltfilt_cuda(torch.from_numpy(short), sos)  # the kernel's wrapper raises


def test_filter_layout_of_the_zero_phase_kernel():
    """K5's tile: 32 events (one warp, SOS_TILE_ROWS) per block, each row of
    L + 2 padlen words made odd, staged while 32 rows fit a block's shared
    memory (232,448 bytes), the long-row mode (stride 0: rows in a global
    scratch) beyond. The section count does not enter the layout: the
    coefficients are read from global memory."""
    assert TC.SOS_TILE_ROWS == 32
    assert TC.filter_layout(256, 27) == TC.FilterLayout(
        stride=311, smem_bytes=32 * 311 * 4)  # route B
    assert TC.filter_layout(256, 27).staged
    assert TC.filter_layout(256, 28).stride == 313  # 312 words: made odd
    assert TC.filter_layout(256, 39) == TC.FilterLayout(335, 32 * 335 * 4)  # S = 6
    # the limit: 32 rows of 1,815 words (232,320 bytes) fit, of 1,817 do not
    assert TC.filter_layout(1_761, 27) == TC.FilterLayout(1_815, 232_320)
    assert TC.filter_layout(1_760, 27) == TC.FilterLayout(1_815, 232_320)
    assert TC.filter_layout(1_762, 27) == TC.FilterLayout(0, 0)
    assert not TC.filter_layout(1_762, 27).staged
    assert TC.filter_layout(4_096, 27) == TC.FilterLayout(0, 0)
    assert 4 * 32 * 1_817 > TC.SMEM_BYTES == 232_448
    # five blocks of route B's rows fit an SM's 228 KB (1 KB a block is the
    # system's)
    assert 5 * (32 * 311 * 4 + 1024) <= 228 * 1024 < 6 * (32 * 311 * 4 + 1024)


def test_sosfilt_layout_of_the_one_direction_kernel():
    """K6's layout: whatever the row length, a block is one warp holding two
    buffers of 32 rows of 129 words (chunks of 128 samples, an odd row
    stride: 33,024 bytes); S > 4 adds the 2 S state words of its 32 events
    (256 S bytes). Six such warps fit an SM's 228 KB (1 KB a block is the
    system's); S with no room for one warp in a block's shared memory
    (232,448 bytes) raises."""
    assert (TC.SOSFILT_CHUNK, TC.SOSFILT_GROUP) == (128, 4)
    for S in (1, 2, 3, 4):
        assert TC.sosfilt_layout(S) == TC.SosfiltLayout(chunk=128, smem_bytes=33_024,
                                                        warps_per_sm=6)
    assert TC.sosfilt_layout(6) == TC.SosfiltLayout(128, 33_024 + 6 * 256, 6)
    assert TC.sosfilt_layout(9).smem_bytes == 33_024 + 9 * 256
    assert 6 * (33_024 + 1024) <= 228 * 1024 < 7 * (33_024 + 1024)
    # the limit: 33,024 + 779 * 256 = 232,448 bytes fit, one more section does not
    assert TC.sosfilt_layout(779) == TC.SosfiltLayout(128, 232_448, 1)
    assert TC.SMEM_BYTES == 232_448
    with pytest.raises(ValueError, match="780 sections"):
        TC.sosfilt_layout(780)


def test_zero_phase_kernel_bound_counts_its_operations():
    """chip_smoke.py's K5 bound counts the float32 operations the kernel
    does: 9 per section and sample over Lp = L + 2 padlen forward and L +
    padlen backward (it stops at the first central sample), 2 L for the
    mean and the DC response, 4 padlen for the reflection. Route B at L =
    256: 21,968 a event, 0.688 ms at 1,048,576 events at the H100's
    non-FMA float32 rate."""
    import chip_smoke

    sos = TF.design_butterworth_sos(*DESIGNS["route_b"])
    S, padlen = sos.shape[0], TF.sosfiltfilt_padlen(sos)
    assert (S, padlen) == (4, 27)
    assert chip_smoke.sosfiltfilt_ops(256, padlen, S) == (310 + 283) * 36 + 512 + 108 == 21_968
    ms, by = chip_smoke.bound_at(8 * 256 * 2**20 + 8 * 2**20,
                                 chip_smoke.sosfiltfilt_ops(256, padlen, S) * 2**20,
                                 chip_smoke.F32_NONFMA_OPS_PER_S)
    assert by == "operations" and round(ms, 4) == 0.6876


@pytest.mark.parametrize("name,between", [
    ("void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda>", True),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>", True),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::AUnaryFunctor>", True),
    ("void (anonymous namespace)::sosfiltfilt_kernel<true>(float const*)", True),
    ("void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast>", False),
    ("Memcpy DtoD (Device -> Device)", False),
    ("void at::native::transpose_kernel<float>", False),
])
def test_route_b_trace_admits_no_transposing_copy(name, between):
    """chip_smoke.py --trace-route-b admits, between a channel group's gather
    and its scatter, the cast, the conditioning and K5 (contiguous
    elementwise, reduction), and nothing strided, no transpose and no
    device-to-device copy."""
    import re

    import chip_smoke

    short = re.sub(r"^void |\(anonymous namespace\)::|at::native::", "", name)
    assert bool(chip_smoke.K5_NEIGHBOURS.match(short)) == between


def _read_floats(ptr: int, n: int) -> np.ndarray:
    import ctypes

    return np.ctypeslib.as_array((ctypes.c_float * n).from_address(ptr)).copy()


@pytest.mark.parametrize("L,dtype", [(256, torch.float32), (250, torch.float32),
                                     (256, torch.int16), (4_096, torch.float32)])
def test_sosfiltfilt_cuda_hands_over_event_major_rows(monkeypatch, L, dtype):
    """sosfiltfilt_cuda hands K5 the event-major (n, L) rows it was given
    (a float32 input's own storage; an int16 input cast once), condition()'s
    mean and DC columns, an (n, L) output, the layout's stride, and a global
    scratch only in the long-row mode; no (L, n) tensor is made and nothing
    is transposed. Checked with a stand-in library on CPU tensors posing as
    CUDA tensors."""
    import contextlib

    from torch.utils._python_dispatch import TorchDispatchMode

    seen = {}

    class Lib:
        def wfa_sosfiltfilt(self, x, mean, dc, coef, out, scratch, prm, stride, stream):
            P = prm._obj
            seen.update(x=x, mean=_read_floats(mean, P.n), dc=_read_floats(dc, P.n), out=out,
                        scratch=scratch, stride=stride, shape=(P.n, P.L, P.S, P.padlen))
            return 0

    class Stream:
        cuda_stream = 0

    ops = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            res = func(*args, **(kwargs or {}))
            outs = res if isinstance(res, (tuple, list)) else (res,)
            ops.append((str(func), [tuple(o.shape) for o in outs if isinstance(o, torch.Tensor)]))
            return res

    monkeypatch.setattr(TC, "_library", Lib)
    monkeypatch.setattr(TC, "_devices", lambda *ts: "cuda")
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    sos = TF.design_butterworth_sos(*DESIGNS["route_b"])
    padlen = TF.sosfiltfilt_padlen(sos)
    n = 40
    x = torch.from_numpy(_waves(n, L)).to(dtype)
    before = TC.sosfiltfilt_cuda.launches
    with Record():
        out = TC.sosfiltfilt_cuda(x, sos)
    assert TC.sosfiltfilt_cuda.launches == before + 1
    assert out.shape == (n, L) and out.dtype == torch.float32
    assert seen["out"] == out.data_ptr()
    if dtype == torch.float32:
        assert seen["x"] == x.data_ptr()  # the caller's own storage
    mean, dc = TF.condition(x.to(torch.float32), sos)
    np.testing.assert_array_equal(seen["mean"], mean[:, 0].numpy())
    np.testing.assert_array_equal(seen["dc"], dc[:, 0].numpy())
    lay = TC.filter_layout(L, padlen)
    assert seen["shape"] == (n, L, 4, padlen) and seen["stride"] == lay.stride
    assert (seen["scratch"] is None) == lay.staged
    shapes = [sh for _, outs in ops for sh in outs]
    names = " ".join(name for name, _ in ops)
    assert (L, n) not in shapes, ops
    assert not any(w in names for w in ("transpose", "permute", "aten.t.")), names
    if not lay.staged:
        assert (n, L + 2 * padlen) in shapes  # the long-row scratch


def test_bandpass_filter_convenience():
    waves = _waves(16, 256)
    out = TC.bandpass_filter(torch.from_numpy(waves), 0.1, 0.2, 0.5, order=2).numpy()
    ref = JP.bandpass_filter_pallas(waves, 0.1, 0.2, 0.5, order=2, interpret=True)
    assert _rel(out, ref) < 5e-5


# ---------------------------------------------------------------------------
# Savitzky-Golay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,poly,L", [(5, 2, 256), (11, 2, 256), (8, 2, 256),
                                          (21, 3, 9), (3, 3, 64)])
def test_savgol_against_jax_and_scipy(window, poly, L):
    waves = np.round(_waves(32, L, seed=2))  # integer ADC values, as st_waveforms holds
    out = TF.savgol_device(waves, window, poly, device="cpu")
    ref = JF.savgol_device(waves, window, poly)
    assert out.dtype == np.float32 and out.shape == waves.shape
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    w = min(window, L) - (min(window, L) % 2 == 0)
    if w > poly:
        sci = savgol_filter(waves.astype(np.float64), w, poly, axis=-1, mode="interp")
        np.testing.assert_allclose(out, sci, atol=2e-2)
    else:  # window <= polyorder passes through
        np.testing.assert_array_equal(out, waves)


# ---------------------------------------------------------------------------
# apply_filter / filter_pool
# ---------------------------------------------------------------------------

def test_apply_filter_against_jax():
    waves = _waves(12, 128, seed=3)
    sos = TF.design_butterworth_sos(*DESIGNS["order4"])
    bw = TF.apply_filter(waves, "BW", bw_sos=sos, device="cpu")
    assert bw.dtype == np.float32 and _rel(bw, JF.apply_filter(waves, "BW", bw_sos=sos)) < 5e-4
    sg = TF.apply_filter(waves, "SG", sg_window_size=11, sg_poly_order=3, device="cpu")
    np.testing.assert_allclose(sg, JF.apply_filter(waves, "SG", sg_window_size=11, sg_poly_order=3),
                               rtol=1e-5)
    for ftype, kw in (("BW", {"bw_sos": sos}), ("SG", {"sg_window_size": 7, "sg_poly_order": 2})):
        np.testing.assert_array_equal(TF.apply_filter(waves, ftype, engine="scipy", **kw),
                                      JF.apply_filter(waves, ftype, engine="scipy", **kw))
    # a tensor is filtered where it lies and stays a tensor
    t = TF.apply_filter(torch.from_numpy(waves), "BW", bw_sos=sos)
    assert isinstance(t, torch.Tensor) and np.array_equal(t.numpy(), bw)
    for args, kw in ((("XX",), {}), (("BW",), {}), (("SG",), {"sg_window_size": 5})):
        with pytest.raises(ValueError) as et:
            TF.apply_filter(waves, *args, **kw)
        with pytest.raises(ValueError) as ej:
            JF.apply_filter(waves, *args, **kw)
        assert str(et.value) == str(ej.value)


class _View:
    """The two attributes filter_pool reads from a RecordsView."""

    def __init__(self, records, wave_pool):
        self.records, self.wave_pool = records, wave_pool


@pytest.mark.parametrize("ftype,cfg", [
    ("savgol", {"sg_window_size": 7, "sg_poly_order": 2}),
    ("butterworth", {"filter_order": 2, "lowcut": 0.05, "highcut": 0.2, "fs": 0.5}),
])
def test_filter_pool_against_jax(ftype, cfg):
    rng = np.random.default_rng(2)
    lengths = np.array([64, 128, 96, 128], dtype=np.int32)
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    pool = rng.integers(800, 1200, int(lengths.sum())).astype(np.uint16)
    view = _View({"wave_offset": offsets, "event_length": lengths}, pool)
    out = TF.filter_pool(view, ftype, cfg, device="cpu")
    ref = JF.filter_pool(view, ftype, cfg)
    assert out.dtype == np.float32 and out.shape == ref.shape
    if ftype == "savgol":
        np.testing.assert_allclose(out, ref, rtol=1e-5)
    else:
        assert _rel(out, ref) < 5e-5


# ---------------------------------------------------------------------------
# the filtered_waveforms plugin in a CPU Context
# ---------------------------------------------------------------------------

def _two_channel_st(n=12, L=64):
    st = jfix.make_fake_st_waveforms(n_events=n, wave_length=L, pulse_height=200,
                                     noise_rms=3.0, seed=3)
    st["channel"] = (np.arange(n) % 2).astype(np.int16)
    return st


def _contexts(tmp_path, st, config=None):
    jctx = jfix.make_tiny_context(tmp_path / "jax", st_waveforms=st)
    jctx.register(jplug.FilteredWaveformsPlugin())
    tctx = tfix.make_tiny_context(tmp_path / "port", st_waveforms=st, config={"device": "cpu"})
    tctx.register(tplug.FilteredWaveformsPlugin())
    for ctx in (jctx, tctx):
        ctx.set_config({"filtered_waveforms": config or {}})
    return jctx, tctx


@pytest.mark.parametrize("variant", ["sg_default", "bw_route_b", "channel_override_bw",
                                     "scipy_engine"])
def test_plugin_against_jax(tmp_path, variant):
    bw = dict(zip(("filter_order", "lowcut", "highcut", "fs"), DESIGNS["route_b"]))
    config = {
        "sg_default": {},
        "bw_route_b": dict(bw, filter_type="BW"),
        # tests/test_filter_channel_overrides.py:37-49: channel 1 runs BW
        "channel_override_bw": {"sg_window_size": 7, "channel_config": {
            "0:1": {"filter_type": "BW", "filter_order": 2, "lowcut": 0.01,
                    "highcut": 0.2, "fs": 0.5}}},
        "scipy_engine": dict(bw, filter_type="BW", engine="scipy"),
    }[variant]
    st = _two_channel_st(n=24, L=128)
    jctx, tctx = _contexts(tmp_path, st, config)
    ref = jctx.get_data("test_run", "filtered_waveforms")
    out = tctx.get_data("test_run", "filtered_waveforms")
    assert out.field_names == ref.field_names
    for f in ref.field_names:
        if f != "wave":
            np.testing.assert_array_equal(np.asarray(out[f]), np.asarray(ref[f]), err_msg=f)
    wave = out["wave"]
    if variant == "scipy_engine":
        assert isinstance(wave, np.ndarray)
        np.testing.assert_array_equal(wave, np.asarray(ref["wave"]))
        return
    # the plugin filters on the Context's device; the Context hands the
    # column back on the host once get_data returns, as the JAX plugin does
    computed = tctx.get_plugin("filtered_waveforms").compute(tctx, "test_run")["wave"]
    assert isinstance(computed, torch.Tensor) and computed.device == tctx.device
    assert isinstance(wave, np.ndarray)
    np.testing.assert_array_equal(wave, computed.numpy())
    rw = np.asarray(ref["wave"])
    assert wave.dtype == np.float32
    ch = np.asarray(out["channel"])
    for c in (0, 1):
        rows = ch == c
        is_bw = variant == "bw_route_b" or (variant == "channel_override_bw" and c == 1)
        if is_bw:
            assert _rel(wave[rows], rw[rows]) < 5e-4
        else:
            np.testing.assert_allclose(wave[rows], rw[rows], rtol=1e-5)
    for ctx in (jctx, tctx):
        ctx.flush_saves()


@pytest.mark.parametrize("config", [
    {"filter_type": "BW"},  # the plugin's own defaults: highcut 0.5 = fs
    {"filter_type": "SG", "sg_window_size": 5, "sg_poly_order": 7},
    {"filter_type": "SG", "sg_window_size": 0},
    {"filter_type": "BW", "lowcut": 0.2, "highcut": 0.1},
])
def test_plugin_invalid_configs_raise_as_jax(tmp_path, config):
    jctx, tctx = _contexts(tmp_path, _two_channel_st(), config)
    with pytest.raises(ValueError) as ej:
        jctx.get_data("test_run", "filtered_waveforms")
    with pytest.raises(ValueError) as et:
        tctx.get_data("test_run", "filtered_waveforms")
    assert str(et.value) == str(ej.value)
    if config == {"filter_type": "BW"}:
        assert "Nyquist" in str(et.value)
    plugin = tctx.get_plugin("filtered_waveforms")
    tctx.set_config({"filtered_waveforms": {"filter_type": "FFT"}})
    with pytest.raises(Exception, match="FFT|one of|Unsupported"):
        tplug.resolve_filter_config(tctx, plugin)


def test_plugin_lineage_rotates_on_tracked_options_only(tmp_path):
    _, tctx = _contexts(tmp_path, _two_channel_st())
    key = lambda: tctx.key_for("test_run", "filtered_waveforms")
    k0 = key()
    for untracked in ({"engine": "scipy"}, {"batch_size": 64}, {"max_workers": 3}):
        tctx.set_config({"filtered_waveforms": untracked})
        assert key() == k0, untracked
    tctx.set_config({"filtered_waveforms": {"channel_config": {"0:1": {"sg_window_size": 15}}}})
    k1 = key()
    assert k1 != k0
    tctx.set_config({"filtered_waveforms": {"filter_type": "BW", "highcut": 0.2}})
    assert key() not in (k0, k1)


def test_plugin_target_reloads_float32_from_cache(tmp_path):
    """The port's counterpart of tests/test_filtering.py:132: a device wave
    column saved as a target reloads as f4 with equal values."""
    st = jfix.make_fake_st_waveforms(n_events=8, wave_length=64, noise_rms=3.0)
    store = tmp_path / "s"

    def ctx():
        c = tfix.make_tiny_context(store, st_waveforms=st, config={"device": "cpu"})
        c.register(tplug.FilteredWaveformsPlugin())
        return c

    first = ctx()
    fresh = first.get_data("test_run", "filtered_waveforms").to_numpy()
    first.flush_saves()
    assert fresh["wave"].dtype == np.float32
    assert not np.array_equal(fresh["wave"], fresh["wave"].astype(np.int16))
    second = ctx()
    assert second.is_cache_hit("test_run", "filtered_waveforms")
    reloaded = second.get_data("test_run", "filtered_waveforms").to_numpy()
    assert reloaded["wave"].dtype == np.float32
    np.testing.assert_array_equal(reloaded["wave"], fresh["wave"])
    assert "plugin.filtered_waveforms.compute" not in second.profiler.stats()


def test_schema_and_dtype_helpers_match_jax():
    assert tplug.FILTER_OPTION_NAMES == jplug.FILTER_OPTION_NAMES
    assert tplug.FILTER_ENGINE_VERSION == jplug.FILTER_ENGINE_VERSION
    assert tplug.FILTERED_WAVEFORM_SCHEMA.numpy_dtype(wave_length=16) == \
        jplug.FILTERED_WAVEFORM_SCHEMA.numpy_dtype(wave_length=16)
    src = jfix.make_fake_st_waveforms(n_events=2, wave_length=16).dtype
    assert tplug.create_filtered_waveform_dtype(src) == jplug.create_filtered_waveform_dtype(src)
    assert set(tplug.FilteredWaveformsPlugin.options) == set(jplug.FilteredWaveformsPlugin.options)
    for name, opt in jplug.FilteredWaveformsPlugin.options.items():
        mine = tplug.FilteredWaveformsPlugin.options[name]
        assert (mine.default, mine.track) == (opt.default, opt.track), name
