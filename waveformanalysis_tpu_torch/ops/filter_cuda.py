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
  two-pass path instead on the event-major rows: the reflection in torch,
  K6 forward, K6 in reverse over the forward output, the centre plus the DC
  response (no transposing copy, no flip);
- ``sosfilt_cuda`` (K6, ``wfa_sosfilt``, replacing ``_sosfilt_kernel``): one
  cascade over the event-major (n, T) rows with per-event initial state,
  forward or in reverse; ``sosfilt_layout`` says how it holds the rows;
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
from waveformanalysis_tpu_torch.ops.chain_tile_cuda import (
    SM_BLOCK_RESERVED,
    SM_BLOCKS,
    SM_SMEM_BYTES,
)


class _SosParams(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in ("n", "L", "S", "padlen")]


def _library() -> ctypes.CDLL:
    """Build (at first use) and bind both entries of ``csrc/sosfilt.cu``."""
    ptr = ctypes.c_void_p
    _scan_library("sosfilt", "wfa_sosfiltfilt",
                  [ptr] * 6 + [ctypes.POINTER(_SosParams), ctypes.c_int, ptr])
    return _scan_library("sosfilt", "wfa_sosfilt",
                         [ptr] * 4 + [ctypes.POINTER(_SosParams), ctypes.c_int, ptr])


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


SOSFILT_CHUNK = 128  # K6's samples of a row a warp holds at a time (kSosChunk)
SOSFILT_GROUP = 4  # sections whose state K6 keeps in registers (kChunk)


@dataclass(frozen=True)
class SosfiltLayout:
    """How K6 holds its rows (``csrc/sosfilt.cu``): a block is one warp of
    32 events; the C entry computes the same shared memory from S."""

    chunk: int  # samples of each row a warp copies and filters at a time
    smem_bytes: int  # dynamic shared memory per block (one warp)
    warps_per_sm: int  # warps (blocks) an SM's shared memory holds


def sosfilt_layout(S: int) -> SosfiltLayout:
    """K6's layout for S sections, whatever the row length: two buffers of
    32 rows of ``SOSFILT_CHUNK + 1`` words (an odd row stride) and, for
    S > SOSFILT_GROUP, the 2 S state words of each of the 32 events between
    chunks (``sosfilt_words``). Raises where one warp's state does not fit
    a block's shared memory."""
    smem = 4 * (2 * 32 * (SOSFILT_CHUNK + 1) + (2 * S * 32 if S > SOSFILT_GROUP else 0))
    if smem > SMEM_BYTES:
        raise ValueError(f"{S} sections: K6's buffers and state ({smem} bytes) exceed "
                         f"a block's shared memory ({SMEM_BYTES} bytes)")
    return SosfiltLayout(SOSFILT_CHUNK, smem,
                         min(SM_BLOCKS, SM_SMEM_BYTES // (smem + SM_BLOCK_RESERVED)))


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


def sosfilt_cuda(x: torch.Tensor, sos: np.ndarray, zi: torch.Tensor,
                 reverse: bool = False) -> torch.Tensor:
    """One cascade over the event-major (n, T) float32 rows from per-event
    initial state ``zi`` (2S, n); returns (n, T) float32. ``reverse`` runs
    each row from its last sample to its first and stores each output in
    place of its input (``sosfilt(x.flip(1)).flip(1)`` without the flips).

    CUDA tensors launch K6; CPU tensors run ``ops.filtering.sosfilt_plain``.
    """
    if _devices(x, zi) == "cpu":
        return FLT.sosfilt_plain(x, sos, zi, reverse)
    n, T = x.shape
    S = int(np.asarray(sos).shape[0])
    dev = x.device
    _check(x, "x", torch.float32, (n, T), dev)
    _check(zi, "zi", torch.float32, (2 * S, n), dev)
    sosfilt_layout(S)  # raises where S does not fit
    lib = _library()
    with torch.cuda.device(dev):
        coef = coefficient_table(sos, dev)
        y = torch.empty_like(x)
        prm = _SosParams(n=n, L=T, S=S, padlen=0)
        err = lib.wfa_sosfilt(x.data_ptr(), zi.data_ptr(), coef.data_ptr(), y.data_ptr(),
                              ctypes.byref(prm), int(reverse), _stream(dev))
    if err != 0:
        raise RuntimeError(f"sosfilt kernel launch failed: cudaError {err}")
    if n and T:
        count_launch(sosfilt_cuda)
    return y


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
    """The Pallas two-pass path (``_sosfiltfilt_pallas_jit(fused=False)``)
    on the event-major rows of the mean-removed batch ``xc``: the odd
    reflection, K6 forward from ``zi * ext[:, 0]``, K6 in reverse from
    ``zi * y[:, -1]``, the central L samples plus the DC response."""
    L = xc.shape[1]
    # the unit state of FLT._zi_times from the table already on the card (a
    # host copy would make the host wait for the stream)
    zi = coefficient_table(sos, xc.device)[:, 5:].reshape(-1, 1)
    ext = FLT.reflect(xc, padlen)
    y = sosfilt_cuda(ext, sos, zi * ext[:, 0])
    y2 = sosfilt_cuda(y, sos, zi * y[:, -1], reverse=True)
    return y2[:, padlen:padlen + L] + dc


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
