"""Digital filtering: zero-phase IIR (Butterworth) and Savitzky-Golay.

Port of ``waveformanalysis_tpu/ops/filtering.py``, with its numeric
contract:

- BW: ``butter(order, [lo, hi], output='sos')`` + ``sosfiltfilt`` zero-phase
  forward-backward filtering with scipy's odd-reflection padding and
  ``sosfilt_zi``-scaled initial conditions; waves no longer than the pad
  length pass through unfiltered (the reference padlen guard).
- SG: ``savgol_filter(..., mode='interp')`` — interior FIR, edges from
  polynomial least-squares fits; even windows clamp down to odd.

The host design code (``design_butterworth_sos``, ``sosfiltfilt_padlen``,
``sosfilt_zi``, ``_savgol_matrices``) is the JAX package's, copied
unchanged, so both packages derive the same coefficients with the same
numpy code.

On the card the IIR cascade is the hand-written kernel behind
``ops/filter_cuda.py`` (``csrc/sosfilt.cu``). Its plain PyTorch version is
here, in place of the JAX package's associative-scan formulation:
``sosfilt_plain`` (one direction) and ``sosfiltfilt_plain`` (zero phase) loop
over samples doing exactly the kernel's float32 arithmetic in the kernel's
order, so on the same conditioned input the two agree bit for bit. Their
contract is scipy's ``sosfiltfilt``. The float32 conditioning is the Pallas
path's: the per-wave mean (sum / L) is removed before the cascade and its
exact DC response ``mean * H(1)^2`` added back, with the coefficients, the
DC gain and the initial conditions derived in float64 and rounded to
float32 once.

SG runs as plain PyTorch on either device: the interior as an explicit
weighted sum of shifted slices and the edges as elementwise products
summed in float32, so no convolution or matrix product (and so no TF32 on
the card) is involved.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from waveformanalysis_tpu_torch.device import resolve_device, to_numpy

KERNEL_VERSION = "filtering-v1"


# --------------------------------------------------------------------------
# Filter design (host, tiny, exact) — the JAX package's code
# --------------------------------------------------------------------------

def design_butterworth_sos(
    order: int, lowcut: float, highcut: float, fs: float
) -> np.ndarray:
    """Bandpass Butterworth as second-order sections (scipy design)."""
    from scipy.signal import butter

    if fs <= 0:
        raise ValueError(f"fs ({fs}) must be > 0")
    if order <= 0:
        raise ValueError(f"filter order ({order}) must be > 0")
    if lowcut <= 0 or highcut <= 0:
        raise ValueError("cutoff frequencies must be > 0")
    if lowcut >= highcut:
        raise ValueError(f"lowcut ({lowcut}) must be < highcut ({highcut})")
    if highcut >= fs / 2:
        raise ValueError(f"highcut ({highcut}) must be < Nyquist ({fs / 2})")
    return butter(order, [lowcut, highcut], btype="band", output="sos", fs=fs)


def sosfiltfilt_padlen(sos: np.ndarray) -> int:
    """scipy's default sosfiltfilt pad length."""
    n_sections = int(sos.shape[0])
    zeros_at_origin = int((sos[:, 2] == 0).sum())
    poles_at_origin = int((sos[:, 5] == 0).sum())
    return 3 * (2 * n_sections + 1 - min(zeros_at_origin, poles_at_origin))


def sosfilt_zi(sos: np.ndarray) -> np.ndarray:
    """Per-section steady-state initial conditions for a unit step
    (scipy.signal.sosfilt_zi semantics, transposed direct form II)."""
    sos = np.asarray(sos, dtype=np.float64)
    n_sections = sos.shape[0]
    zi = np.zeros((n_sections, 2))
    scale = 1.0
    for k in range(n_sections):
        b = sos[k, :3]
        a = sos[k, 3:]
        # state map: z = M z + v * x
        M = np.array([[-a[1], 1.0], [-a[2], 0.0]])
        v = np.array([b[1] - a[1] * b[0], b[2] - a[2] * b[0]])
        z_star = np.linalg.solve(np.eye(2) - M, v)
        zi[k] = scale * z_star
        scale *= b.sum() / a.sum()
    return zi


@lru_cache(maxsize=64)
def _savgol_matrices(window: int, polyorder: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fir_coeffs, left_edge_matrix, right_edge_matrix) for mode='interp'.

    Edge matrices map the first/last ``window`` samples to the halfwin fitted
    edge values (pure linear algebra — exact parity with scipy's polyfit
    edge handling).
    """
    halflen = window // 2
    pos = np.arange(-halflen, window - halflen, dtype=np.float64)
    # FIR coefficients: projection of delta onto poly basis evaluated at 0
    V = np.vander(pos, polyorder + 1, increasing=True)  # (window, p+1)
    pinv = np.linalg.pinv(V)  # (p+1, window)
    fir = pinv[0]  # evaluate fitted poly at x=0
    # edge fit: t = 0..window-1 sample positions
    t = np.arange(window, dtype=np.float64)
    Vt = np.vander(t, polyorder + 1, increasing=True)
    pinv_t = np.linalg.pinv(Vt)  # (p+1, window)
    # left edge: evaluate at t = 0..halflen-1 ; right edge at the mirror
    eval_left = np.vander(t[:halflen], polyorder + 1, increasing=True)
    E_left = eval_left @ pinv_t  # (halflen, window)
    eval_right = np.vander(t[window - halflen :], polyorder + 1, increasing=True)
    E_right = eval_right @ pinv_t
    return fir[::-1].copy(), E_left, E_right


# --------------------------------------------------------------------------
# Float32 coefficients and conditioning (shared by the kernel and its plain
# version, so both see identical inputs)
# --------------------------------------------------------------------------

def sos_coefficients(sos: np.ndarray) -> np.ndarray:
    """(S, 7) float32 rows ``b0, b1, b2, a1, a2, zi0, zi1``: the sections
    normalised by a0 and the unit-step initial conditions, each computed in
    float64 and rounded to float32 once (the Pallas kernel's constants)."""
    s = np.asarray(sos, np.float64)
    a0 = s[:, 3]
    cols = [s[:, 0] / a0, s[:, 1] / a0, s[:, 2] / a0, s[:, 4] / a0, s[:, 5] / a0]
    zi = sosfilt_zi(s)
    return np.stack(cols + [zi[:, 0], zi[:, 1]], axis=1).astype(np.float32)


def dc_gain_squared(sos: np.ndarray) -> float:
    """H(1)^2 of the cascade in float64, rounded to float32 once."""
    s = np.asarray(sos, np.float64)
    gain = float(np.prod(np.sum(s[:, :3], axis=1) / np.sum(s[:, 3:], axis=1)))
    return float(np.float32(gain * gain))


def condition(x: torch.Tensor, sos: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, dc_response) of an (n, L) batch for the float32 conditioning:
    the cascade runs on ``x - mean`` and ``dc_response = mean * H(1)^2`` is
    added to its output. The mean is ``sum / L`` (a division, as
    ``jnp.mean`` does it; torch's CUDA ``mean`` multiplies by 1/L)."""
    mean = x.sum(dim=1, keepdim=True) / x.shape[1]
    return mean, mean * dc_gain_squared(sos)


def reflect(x: torch.Tensor, padlen: int) -> torch.Tensor:
    """scipy's odd extension of an (n, L) batch to (n, L + 2 * padlen):
    ``2 x[0] - x[padlen..1]`` before the row and ``2 x[L-1] - x[L-2..]``
    after it, the mirrored samples gathered by index (no flip)."""
    L = x.shape[1]
    mirror = torch.cat([torch.arange(padlen, 0, -1, device=x.device),
                        torch.arange(L - 2, L - 2 - padlen, -1, device=x.device)])
    ends = x.index_select(1, mirror)
    left = 2.0 * x[:, :1] - ends[:, :padlen]
    right = 2.0 * x[:, -1:] - ends[:, padlen:]
    return torch.cat([left, x, right], dim=1)


# --------------------------------------------------------------------------
# The plain versions of the IIR kernels
# --------------------------------------------------------------------------

def sosfilt_plain(x: torch.Tensor, sos: np.ndarray, zi: torch.Tensor,
                  reverse: bool = False) -> torch.Tensor:
    """One direct-form-II-transposed cascade over the event-major (n, T)
    float32 rows with per-event initial state ``zi`` (2S, n) (rows z0, z1
    of section 0, then of section 1, ...); returns (n, T). ``reverse`` runs
    each row from its last sample to its first, each output stored in place
    of its input.

    Per sample and section, in this order: ``y = b0*x + z0``,
    ``z0 = (b1*x - a1*y) + z1``, ``z1 = b2*x - a2*y``; ``y`` feeds the next
    section. The contract of the K6 kernel (``ops.filter_cuda.sosfilt_cuda``).
    The loop runs over a time-major copy, one (n,) step a sample.
    """
    coef = sos_coefficients(sos)[:, :5].tolist()  # exact float32 values
    z = list(zi.unbind(0))
    x_t = x.t().contiguous()
    y_t = torch.empty_like(x_t)
    T = x_t.shape[0]
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        v = x_t[t]
        for s, (b0, b1, b2, a1, a2) in enumerate(coef):
            ys = b0 * v + z[2 * s]
            z[2 * s] = b1 * v - a1 * ys + z[2 * s + 1]
            z[2 * s + 1] = b2 * v - a2 * ys
            v = ys
        y_t[t] = v
    return y_t.t().contiguous()


def _zi_times(sos: np.ndarray, first: torch.Tensor) -> torch.Tensor:
    """(2S, n) initial state ``zi_unit * first`` (float32 products)."""
    zi = torch.from_numpy(sos_coefficients(sos)[:, 5:].reshape(-1).copy()).to(first.device)
    return zi[:, None] * first[None, :]


def sosfiltfilt_plain(x: torch.Tensor, sos: np.ndarray) -> torch.Tensor:
    """Zero-phase filter of an (n, L) batch (L > padlen), float32 out: the
    contract of the K5 kernel (``ops.filter_cuda.sosfiltfilt_cuda``), on any
    device. Conditioning, odd reflection, the forward cascade from
    ``zi * ext[0]``, the backward cascade from ``zi * y_fwd[-1]``, the
    central L samples, the DC response added back."""
    x = x.to(torch.float32)
    mean, dc = condition(x, sos)
    padlen = sosfiltfilt_padlen(sos)
    L = x.shape[1]
    ext = reflect(x - mean, padlen)
    y = sosfilt_plain(ext, sos, _zi_times(sos, ext[:, 0]))
    y2 = sosfilt_plain(y, sos, _zi_times(sos, y[:, -1]), reverse=True)
    return y2[:, padlen:padlen + L] + dc


# --------------------------------------------------------------------------
# Tensor entry points (run where the tensor lies)
# --------------------------------------------------------------------------

def sosfiltfilt(x: torch.Tensor, sos: np.ndarray) -> torch.Tensor:
    """Zero-phase Butterworth of an (n, L) tensor, float32 out, on the
    tensor's device: a CUDA tensor launches the K5 kernel, a CPU tensor runs
    :func:`sosfiltfilt_plain`. Waves with L <= padlen pass through."""
    if x.shape[-1] <= sosfiltfilt_padlen(sos):
        return x.to(torch.float32).clone()
    from waveformanalysis_tpu_torch.ops.filter_cuda import sosfiltfilt_cuda

    return sosfiltfilt_cuda(x, sos)


def savgol(x: torch.Tensor, window: int, polyorder: int) -> torch.Tensor:
    """Savitzky-Golay smoothing (mode='interp') of an (n, L) tensor, float32
    out, on the tensor's device; the window clamps to L and down to odd, and
    a window <= polyorder passes the waves through."""
    x = x.to(torch.float32)
    L = x.shape[1]
    window = min(int(window), L)
    if window % 2 == 0:
        window -= 1
    if window <= polyorder:
        return x.clone()
    fir, E_left, E_right = _savgol_matrices(window, int(polyorder))
    m = L - window + 1  # interior outputs: positions halflen .. L-halflen-1
    taps = fir.astype(np.float32).tolist()
    interior = taps[0] * x[:, :m]
    for k in range(1, window):
        interior = interior + taps[k] * x[:, k:k + m]

    def edge(samples: torch.Tensor, E: np.ndarray) -> torch.Tensor:
        E32 = torch.from_numpy(E.astype(np.float32)).to(x.device)
        return (samples[:, None, :] * E32[None]).sum(dim=-1)

    left = edge(x[:, :window], E_left)
    right = edge(x[:, L - window:], E_right)
    return torch.cat([left, interior, right], dim=1)


# --------------------------------------------------------------------------
# Array entry points (the JAX package's signatures, plus ``device``)
# --------------------------------------------------------------------------

Device = Union[str, torch.device, None]


def _on_device(fn, waves: Any, device: Device, dtype: Any, *args) -> np.ndarray:
    """Run a tensor filter on ``device`` over a host (n, L) or (L,) array."""
    dev = resolve_device(device)
    arr = np.asarray(waves, dtype=np.float32)
    squeeze = arr.ndim == 1
    if squeeze:
        arr = arr[None, :]
    out = to_numpy(fn(torch.from_numpy(np.ascontiguousarray(arr)).to(dev), *args))
    out = out.astype(dtype, copy=False)
    return out[0] if squeeze else out


def sosfiltfilt_device(
    waves: Any, sos: np.ndarray, dtype: Any = np.float32, device: Device = "cuda"
) -> np.ndarray:
    """Zero-phase Butterworth on ``device``; waves (n, L) -> filtered (n, L).

    Waves with L <= padlen are returned unfiltered (reference padlen guard,
    filtering.py:219-224).
    """
    return _on_device(sosfiltfilt, waves, device, dtype, sos)


def sosfiltfilt_scipy(waves: Any, sos: np.ndarray, dtype: Any = np.float32) -> np.ndarray:
    """Host reference path (bit-exact vs the reference implementation)."""
    from scipy.signal import sosfiltfilt as scipy_sosfiltfilt

    waves = np.asarray(waves, dtype=np.float32)
    padlen = sosfiltfilt_padlen(sos)
    if waves.shape[-1] <= padlen:
        return np.array(waves, dtype=dtype, copy=True)
    return np.asarray(scipy_sosfiltfilt(sos, waves, axis=-1), dtype=dtype)


def savgol_device(
    waves: Any, window: int, polyorder: int, dtype: Any = np.float32,
    device: Device = "cuda",
) -> np.ndarray:
    """Savitzky-Golay smoothing (mode='interp' parity) on ``device``."""
    return _on_device(savgol, waves, device, dtype, window, polyorder)


def savgol_scipy(waves: Any, window: int, polyorder: int, dtype: Any = np.float32) -> np.ndarray:
    from scipy.signal import savgol_filter

    waves = np.asarray(waves, dtype=np.float32)
    L = waves.shape[-1]
    window = min(int(window), L)
    if window % 2 == 0:
        window -= 1
    if window <= polyorder:
        return np.array(waves, dtype=dtype, copy=True)
    return np.asarray(
        savgol_filter(waves, window_length=window, polyorder=int(polyorder),
                      axis=-1, mode="interp"),
        dtype=dtype,
    )


# --------------------------------------------------------------------------
# Batch entry points
# --------------------------------------------------------------------------

def apply_filter(
    waves: Any,
    filter_type: str,
    bw_sos: Optional[np.ndarray] = None,
    sg_window_size: Optional[int] = None,
    sg_poly_order: Optional[int] = None,
    engine: str = "device",
    device: Device = "cuda",
) -> Any:
    """Apply a configured filter to a (n, L) batch; returns float32.

    A tensor is filtered where it lies and comes back as a tensor (engine
    "device" only); an array comes back as an array, filtered on ``device``
    (engine "device") or by scipy on the host (engine "scipy").
    """
    if filter_type == "BW":
        if bw_sos is None:
            raise ValueError("BW filter requires SOS coefficients")
    elif filter_type == "SG":
        if sg_window_size is None or sg_poly_order is None:
            raise ValueError("SG filter requires sg_window_size and sg_poly_order")
    else:
        raise ValueError(f"Unsupported filter type: {filter_type!r}; use 'BW' or 'SG'.")
    if isinstance(waves, torch.Tensor):
        if engine != "device":
            raise ValueError(f"engine {engine!r} filters host arrays, got a tensor")
        if filter_type == "BW":
            return sosfiltfilt(waves, bw_sos)
        return savgol(waves, sg_window_size, sg_poly_order)
    if filter_type == "BW":
        if engine == "device":
            return sosfiltfilt_device(waves, bw_sos, device=device)
        return sosfiltfilt_scipy(waves, bw_sos)
    if engine == "device":
        return savgol_device(waves, sg_window_size, sg_poly_order, device=device)
    return savgol_scipy(waves, sg_window_size, sg_poly_order)


def filter_pool(
    view: Any,
    filter_type: str = "butterworth",
    filter_config: Optional[Dict[str, Any]] = None,
    sampling_rate_hz: float = 500e6,
    engine: str = "device",
    device: Device = "cuda",
) -> np.ndarray:
    """Filter an entire wave_pool through a RecordsView (per-record lengths
    honored); returns a float32 pool with identical offsets."""
    cfg = dict(filter_config or {})
    if filter_type in ("butterworth", "BW"):
        # GHz convention (only frequency ratios matter to the design)
        fs_ghz = float(cfg.get("fs", sampling_rate_hz / 1e9))
        sos = design_butterworth_sos(
            order=int(cfg.get("filter_order", 4)),
            lowcut=float(cfg.get("lowcut", 0.1 * fs_ghz)),
            highcut=float(cfg.get("highcut", 0.4 * fs_ghz)),
            fs=fs_ghz,
        )
        run = lambda w: apply_filter(w, "BW", bw_sos=sos, engine=engine, device=device)
    elif filter_type in ("savgol", "SG"):
        window = int(cfg.get("sg_window_size", 11))
        poly = int(cfg.get("sg_poly_order", 3))
        run = lambda w: apply_filter(
            w, "SG", sg_window_size=window, sg_poly_order=poly, engine=engine,
            device=device,
        )
    else:
        raise ValueError(f"Unsupported filter type: {filter_type!r}")

    # Filtering must see each record at its TRUE length (padding would
    # pollute edge samples), so batch per unique event_length.
    offsets = np.asarray(view.records["wave_offset"], dtype=np.int64)
    lengths = np.asarray(view.records["event_length"], dtype=np.int64)
    total = int(lengths.sum())
    out = np.zeros(max(total, len(view.wave_pool)), dtype=np.float32)
    for L in np.unique(lengths):
        if L <= 0:
            continue
        rows = np.flatnonzero(lengths == L)
        idx = offsets[rows][:, None] + np.arange(L)[None, :]
        group = view.wave_pool[idx].astype(np.float32)
        filtered = run(group)
        out[idx.reshape(-1)] = filtered.reshape(-1)
    return out
