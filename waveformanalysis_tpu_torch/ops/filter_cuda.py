"""Zero-phase Butterworth filtering hand-written in CUDA.

Port of ``waveformanalysis_tpu/ops/filter_pallas.py`` into ``csrc/sosfilt.cu``:

- ``sosfiltfilt_cuda`` (K5, ``wfa_sosfiltfilt``, replacing
  ``_sosfiltfilt_fused_kernel``): scipy's ``sosfiltfilt`` of an (n, L)
  batch in one launch. The wrapper computes the float32 conditioning of
  ``_sosfiltfilt_pallas_jit`` (``ops.filtering.condition``: the per-wave
  mean and its DC response ``mean * H(1)^2``) and hands the kernel the
  event-major rows as they lie, with those two columns; the kernel removes
  the mean as it stages a row, reflects, runs the forward and backward
  cascades and adds the DC response as it stores. ``filter_layout`` says how
  the kernel holds the rows. With ``fused=False`` it runs the Pallas
  two-pass path instead: reflection in torch, then K6 forward, a reversal,
  K6 backward;
- ``sosfilt_cuda`` (K6, ``wfa_sosfilt``, replacing ``_sosfilt_kernel``): one
  cascade over a time-major (T, n) input with per-event initial state;
- ``bandpass_filter``: ``bandpass_filter_pallas``, design and filter.

The TPU path padded n to 1024/2048-event blocks; the kernels mask their
own ragged tail, so nothing is padded here. On CUDA tensors each wrapper
launches its kernel or raises; on CPU tensors it runs the plain version of
``ops/filtering.py`` (``sosfiltfilt_plain``, ``sosfilt_plain``), which is
the contract the kernels are held to, bit for bit on the same inputs.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from waveformanalysis_tpu_torch.kernels._build import count_launch
from waveformanalysis_tpu_torch.ops import filtering as FLT
from waveformanalysis_tpu_torch.ops.chain_scan_cuda import (
    SMEM_BYTES,
    _check,
    _devices,
    _scan_library,
)


class _SosParams(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in ("n", "L", "S", "padlen")]


def _library() -> ctypes.CDLL:
    """Build (at first use) and bind both entries of ``csrc/sosfilt.cu``."""
    ptr = ctypes.c_void_p
    _scan_library("sosfilt", "wfa_sosfiltfilt",
                  [ptr] * 6 + [ctypes.POINTER(_SosParams), ctypes.c_int, ptr])
    return _scan_library("sosfilt", "wfa_sosfilt",
                         [ptr, ptr, ptr, ptr, ctypes.POINTER(_SosParams), ptr])


SOS_TILE_ROWS = 32  # K5's events (threads) per block: one warp (kTileRows)


@dataclass(frozen=True)
class FilterLayout:
    """How K5 holds its rows (``csrc/sosfilt.cu``); the C entry takes
    ``stride`` as it is."""

    stride: int  # 4-byte words per tile row (L + 2 * padlen, made odd); 0: global scratch
    smem_bytes: int  # dynamic shared memory per block

    @property
    def staged(self) -> bool:
        """The rows are filtered in the shared-memory tile."""
        return self.stride > 0


def filter_layout(L: int, padlen: int) -> FilterLayout:
    """K5's layout for rows of L samples and ``padlen`` reflected samples at
    each end: a tile of SOS_TILE_ROWS rows of ``stride`` words per block
    where it fits a block's shared memory, else the long-row mode (each
    thread filters its row in an (n, L + 2 * padlen) global scratch). The
    section count does not enter: the coefficients are read from global
    memory."""
    stride = (L + 2 * padlen) | 1  # odd: 32 rows at one sample hit 32 banks
    smem = 4 * SOS_TILE_ROWS * stride
    if smem > SMEM_BYTES:
        return FilterLayout(0, 0)
    return FilterLayout(stride, smem)


_COEF: Dict[Tuple[bytes, str], torch.Tensor] = {}


def coefficient_table(sos: np.ndarray, device: torch.device) -> torch.Tensor:
    """The kernels' (S, 7) float32 coefficient rows on ``device`` (kept per
    design and device, so a repeated call uploads nothing)."""
    key = (np.asarray(sos, np.float64).tobytes(), str(device))
    if key not in _COEF:
        _COEF[key] = torch.from_numpy(FLT.sos_coefficients(sos)).to(device)
    return _COEF[key]


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def sosfilt_cuda(x_t: torch.Tensor, sos: np.ndarray, zi: torch.Tensor) -> torch.Tensor:
    """One cascade over a time-major (T, n) float32 input from per-event
    initial state ``zi`` (2S, n); returns (T, n) float32.

    CUDA tensors launch K6; CPU tensors run ``ops.filtering.sosfilt_plain``.
    """
    if _devices(x_t, zi) == "cpu":
        return FLT.sosfilt_plain(x_t, sos, zi)
    T, n = x_t.shape
    S = int(np.asarray(sos).shape[0])
    dev = x_t.device
    _check(x_t, "x_t", torch.float32, (T, n), dev)
    _check(zi, "zi", torch.float32, (2 * S, n), dev)
    lib = _library()
    with torch.cuda.device(dev):
        coef = coefficient_table(sos, dev)
        y_t = torch.empty_like(x_t)
        prm = _SosParams(n=n, L=T, S=S, padlen=0)
        err = lib.wfa_sosfilt(x_t.data_ptr(), zi.data_ptr(), coef.data_ptr(),
                              y_t.data_ptr(), ctypes.byref(prm), _stream(dev))
    if err != 0:
        raise RuntimeError(f"sosfilt kernel launch failed: cudaError {err}")
    if n and T:
        count_launch(sosfilt_cuda)
    return y_t


sosfilt_cuda.launches = 0  # kernel launches (not plain-version calls)


def sosfiltfilt_cuda(x: torch.Tensor, sos: np.ndarray, fused: bool = True) -> torch.Tensor:
    """Zero-phase filter of an (n, L) batch with L > padlen; float32 out.

    CUDA tensors launch K5 (``fused=True``) or K6 twice (``fused=False``);
    CPU tensors run ``ops.filtering.sosfiltfilt_plain``.
    """
    if x.dim() != 2:
        raise ValueError(f"x has shape {tuple(x.shape)}, expected (n, L)")
    n, L = x.shape
    padlen = FLT.sosfiltfilt_padlen(sos)
    if L <= padlen:
        raise ValueError(f"wave length {L} must exceed padlen {padlen}")
    if _devices(x) == "cpu":
        return FLT.sosfiltfilt_plain(x, sos)
    dev = x.device
    x = x.to(torch.float32).contiguous()  # event-major, as the caller holds it
    mean, dc = FLT.condition(x, sos)
    if not fused:
        return _two_pass(x - mean, dc, sos, padlen)
    lay = filter_layout(L, padlen)
    lib = _library()
    with torch.cuda.device(dev):
        coef = coefficient_table(sos, dev)
        out = torch.empty((n, L), device=dev)
        scratch = None if lay.staged else torch.empty((n, L + 2 * padlen), device=dev)
        prm = _SosParams(n=n, L=L, S=int(np.asarray(sos).shape[0]), padlen=padlen)
        err = lib.wfa_sosfiltfilt(x.data_ptr(), mean.data_ptr(), dc.data_ptr(), coef.data_ptr(),
                                  out.data_ptr(), None if scratch is None else scratch.data_ptr(),
                                  ctypes.byref(prm), lay.stride, _stream(dev))
    if err != 0:
        raise RuntimeError(f"sosfiltfilt kernel launch failed: cudaError {err}")
    if n:
        count_launch(sosfiltfilt_cuda)
    return out


sosfiltfilt_cuda.launches = 0  # kernel launches (not plain-version calls)


def _two_pass(xc: torch.Tensor, dc: torch.Tensor, sos: np.ndarray, padlen: int) -> torch.Tensor:
    """The Pallas two-pass path (``_sosfiltfilt_pallas_jit(fused=False)``):
    reflection in torch, K6 forward, reversal, K6 backward."""
    L = xc.shape[1]
    ext_t = FLT.reflect(xc, padlen).t().contiguous()
    y = sosfilt_cuda(ext_t, sos, FLT._zi_times(sos, ext_t[0]))
    y_rev = y.flip(0)
    y2 = sosfilt_cuda(y_rev, sos, FLT._zi_times(sos, y_rev[0])).flip(0)
    return (y2[padlen:padlen + L].t() + dc).contiguous()


def bandpass_filter(
    waves: torch.Tensor,
    lowcut_ghz: float,
    highcut_ghz: float,
    fs_ghz: float,
    order: int = 2,
) -> torch.Tensor:
    """Convenience: design + apply the standard Butterworth bandpass."""
    sos = FLT.design_butterworth_sos(order, lowcut_ghz, highcut_ghz, fs_ghz)
    return sosfiltfilt_cuda(waves, sos)
