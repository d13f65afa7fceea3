"""Width crossings for K peak slots per event, hand-written in CUDA.

Port of ``waveformanalysis_tpu/ops/width_scan_pallas.py``
(``width_crossings_scan``) into ``csrc/width_scan.cu``. Only the crossing
search runs in the kernel; the interpolation and validity arithmetic stays
in torch (``ops.widths.width_from_peak_slots_scan``), as it stays in jnp in
the JAX package.

Semantics, per slot with position p (contract of
``ops.widths._width_for_positions``):

- corr = float32(wave) - baseline (the baseline comes from the caller);
- rising crossing for threshold thr: the first t in [0, p) with
  corr[t] >= thr; falling crossing: the first t in [p, L) with
  corr[t] <= thr; not found is reported as L;
- the capture samples are corr[max(t - 1, 0)] and corr[t] at the crossing
  (zeros when not found or when ``interpolation`` is off);
- an empty slot (p < 0 or p >= L) captures no peak value and searches
  nothing: peak_value 0, every index L, every sample 0.

The kernel reads the event-major ``(n, L)`` waves as they are (no
transposing copy), one warp per event (``chain_scan_cuda.row_layout``).
On CUDA tensors ``width_crossings_scan`` launches the kernel or raises; on
CPU tensors it runs ``width_crossings_plain``, the plain PyTorch version
with exactly these semantics.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from waveformanalysis_tpu_torch.ops.chain_scan_cuda import (
    _check,
    _devices,
    _scan_library,
    row_layout,
)

_IDX_KEYS = ("r_low_idx", "r_high_idx", "f_high_idx", "f_low_idx")
_Y_KEYS = (
    "r_low_y0", "r_low_y1", "r_high_y0", "r_high_y1",
    "f_high_y0", "f_high_y1", "f_low_y0", "f_low_y1",
)
OUT_KEYS = _IDX_KEYS + _Y_KEYS + ("peak_value",)


class _WidthParams(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in ("n", "L", "K", "interpolation")] + [
        (f, ctypes.c_float) for f in ("rise_low", "rise_high", "fall_high", "fall_low")
    ]


class _WidthOut(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in OUT_KEYS]


def _library() -> ctypes.CDLL:
    """Build (at first use) and bind the kernel library."""
    return _scan_library("width_scan", "wfa_width_scan", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(_WidthOut), ctypes.POINTER(_WidthParams)] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p])


def width_crossings_plain(
    waves: torch.Tensor,
    baseline: torch.Tensor,
    positions: torch.Tensor,
    rise_low: float,
    rise_high: float,
    fall_high: float,
    fall_low: float,
    interpolation: bool = True,
) -> Dict[str, torch.Tensor]:
    """The plain PyTorch version of the crossing search (module docstring)."""
    corr = waves.to(torch.float32) - baseline.to(torch.float32)[:, None]
    n, L = corr.shape
    K = positions.shape[1]
    dev = corr.device
    pos = torch.arange(L, device=dev, dtype=torch.int32)[None, :]
    p = positions.to(torch.int32)
    occ = (p >= 0) & (p < L)
    pv = torch.where(occ, torch.gather(corr, 1, p.clamp(0, L - 1).long()), 0.0)
    out = {key: torch.full((n, K), L, dtype=torch.int32, device=dev) for key in _IDX_KEYS}
    out.update({key: torch.zeros((n, K), dtype=torch.float32, device=dev) for key in _Y_KEYS})
    out["peak_value"] = pv
    fracs = (rise_low, rise_high, fall_high, fall_low)
    for k in range(K):
        pk = p[:, k:k + 1]
        before = (pos < pk) & occ[:, k:k + 1]  # rising window [0, p)
        after = (pos >= pk) & occ[:, k:k + 1]  # falling window [p, L)
        for j, frac in enumerate(fracs):
            thr = (pv[:, k] * frac)[:, None]
            m = (before & (corr >= thr)) if j < 2 else (after & (corr <= thr))
            idx = torch.where(m, pos, L).amin(dim=1)
            out[_IDX_KEYS[j]][:, k] = idx
            if interpolation:
                found = idx < L
                y0 = torch.gather(corr, 1, (idx - 1).clamp(0, L - 1).long()[:, None])[:, 0]
                y1 = torch.gather(corr, 1, idx.clamp(max=L - 1).long()[:, None])[:, 0]
                out[_Y_KEYS[2 * j]][:, k] = torch.where(found, y0, 0.0)
                out[_Y_KEYS[2 * j + 1]][:, k] = torch.where(found, y1, 0.0)
    return {key: out[key] for key in OUT_KEYS}


def width_crossings_scan(
    waves: torch.Tensor,
    baseline: torch.Tensor,
    positions: torch.Tensor,
    rise_low: float,
    rise_high: float,
    fall_high: float,
    fall_low: float,
    interpolation: bool = True,
) -> Dict[str, torch.Tensor]:
    """First-crossing indices and interpolation samples for K peak slots.

    waves: (n, L) int16 or float32; baseline: (n,) float32; positions:
    (n, K) int32 (< 0 = empty). Returns (n, K) tensors
    ``{r_low,r_high,f_high,f_low}_idx`` (int32, L = not found), the
    matching ``_y0`` / ``_y1`` capture samples and ``peak_value`` (float32).
    CUDA tensors go through the kernel, CPU tensors through
    :func:`width_crossings_plain`.
    """
    if _devices(waves, baseline, positions) == "cpu":
        return width_crossings_plain(waves, baseline, positions, rise_low, rise_high,
                                     fall_high, fall_low, interpolation)
    n, L = waves.shape
    K = positions.shape[1]
    dev = waves.device
    if waves.dtype not in (torch.int16, torch.float32):
        raise TypeError(f"waves has dtype {waves.dtype}, the kernel takes int16 or float32")
    _check(baseline, "baseline", torch.float32, (n,), dev)
    _check(positions, "positions", torch.int32, (n, K), dev)
    waves = waves.contiguous()  # event-major, as the caller holds them
    lay = row_layout(L, waves.element_size(), waves.data_ptr())
    lib = _library()
    with torch.cuda.device(dev):
        outs = {key: torch.empty((n, K), dtype=torch.int32 if key in _IDX_KEYS
                                 else torch.float32, device=dev) for key in OUT_KEYS}
        ptrs = _WidthOut(*(outs[key].data_ptr() for key in OUT_KEYS))
        prm = _WidthParams(n=n, L=L, K=K, interpolation=int(bool(interpolation)),
                           rise_low=rise_low, rise_high=rise_high,
                           fall_high=fall_high, fall_low=fall_low)
        err = lib.wfa_width_scan(waves.data_ptr(), int(waves.dtype == torch.float32),
                                 baseline.data_ptr(), positions.data_ptr(),
                                 ctypes.byref(ptrs), ctypes.byref(prm), lay.rows,
                                 int(lay.staged), int(lay.vec),
                                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"width_scan kernel launch failed: cudaError {err}")
    if n and K:
        width_crossings_scan.launches += 1
    return outs


width_crossings_scan.launches = 0  # kernel launches (not plain-version calls)
