"""The tile-resident chain kernel, hand-written in CUDA.

Port of ``waveformanalysis_tpu/ops/chain_pallas.py``: ``chain_tile_cuda`` /
``make_chain_tile`` (``csrc/chain_tile.cu``) take the place of
``chain_pallas`` / ``make_jit_chain_pallas``. The contract is
``full_chain_step``'s: the same 12 per-event outputs, ``label`` as int8,
and the two int32 overflow scalars derived from the raw per-event
candidate / run counts.

The kernel reads the event-major ``(n, L)`` int16 waves as they are (no
transposing copy): one warp per event stages the row in shared memory, and
``tile_rows`` is the number of events (warps) per thread block. The JAX
package's ``interpret`` flag has no counterpart. On CUDA tensors the
wrapper launches the kernel or raises; on CPU tensors it runs the plain
version, ``full_chain_step`` (the function ``make_chain`` steps).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from waveformanalysis_tpu_torch.models.full_chain import ChainConfig, full_chain_step
from waveformanalysis_tpu_torch.ops.chain_scan_cuda import (
    _OUTS,
    SMEM_BYTES,
    _Outs,
    _Params,
    _devices,
    _params,
    _scan_library,
    chain_outputs,
    check_chain_batch,
    with_overflow,
)

DEFAULT_TILE_ROWS = 8  # events per block: 8 warps, 21 KB of shared memory at L = 256
MAX_TILE_ROWS = 32  # 1024 threads, the most a block holds


def event_smem_bytes(L: int) -> int:
    """Shared memory one event takes (``event_bytes`` in csrc/chain_tile.cu):
    the float32 wave and detection rows, skewed by one word per 32 samples,
    and four 32-entry slot tables."""
    return 4 * (2 * (L + (L >> 5) + 1) + 4 * 32)


MAX_WAVE_LENGTH = 28_113  # the largest L with event_smem_bytes(L) <= SMEM_BYTES


def _check_tile_rows(tile_rows: int) -> None:
    if not 1 <= tile_rows <= MAX_TILE_ROWS:
        raise ValueError(f"tile_rows={tile_rows}: the tile kernel takes 1..{MAX_TILE_ROWS}")


def rows_per_block(L: int, tile_rows: int) -> int:
    """Events per block for rows of L samples: ``tile_rows``, or fewer
    where that many rows do not fit one block's shared memory."""
    _check_tile_rows(tile_rows)
    if L > MAX_WAVE_LENGTH:
        raise ValueError(
            f"wave length {L}: one row takes {event_smem_bytes(L)} bytes of shared "
            f"memory, more than a block holds; the tile kernel takes L <= {MAX_WAVE_LENGTH}"
        )
    return min(tile_rows, SMEM_BYTES // event_smem_bytes(L))


def _library() -> ctypes.CDLL:
    return _scan_library("chain_tile", "wfa_chain_tile", [ctypes.c_void_p] * 4 + [
        ctypes.POINTER(_Outs), ctypes.POINTER(_Params), ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ])


def _launch(waves, event_length, baselines, polarity_codes, cfg,
            tile_rows) -> Dict[str, torch.Tensor]:
    check_chain_batch(waves, event_length, baselines, polarity_codes, cfg)
    n, L = waves.shape
    rows = rows_per_block(L, tile_rows)
    dev = waves.device
    # 16-byte row loads where every row starts on a 16-byte boundary
    vec = int(L % 8 == 0 and waves.data_ptr() % 16 == 0)
    lib = _library()
    with torch.cuda.device(dev):
        outs = chain_outputs(n, dev)
        ptrs = _Outs(*(outs[name].data_ptr() for name, _ in _OUTS))
        prm = _params(cfg, n, L)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.wfa_chain_tile(
            waves.data_ptr(), event_length.data_ptr(), baselines.data_ptr(),
            polarity_codes.data_ptr(), ctypes.byref(ptrs), ctypes.byref(prm),
            rows, vec, stream,
        )
    if err != 0:
        raise RuntimeError(f"chain_tile kernel launch failed: cudaError {err}")
    if n:  # the C entry launches nothing for an empty batch
        chain_tile_cuda.launches += 1
    return with_overflow(outs, cfg)


def chain_tile_cuda(
    waves: torch.Tensor,
    event_length: torch.Tensor,
    baselines: torch.Tensor,
    polarity_codes: torch.Tensor,
    cfg: Optional[ChainConfig] = None,
    tile_rows: int = DEFAULT_TILE_ROWS,
) -> Dict[str, torch.Tensor]:
    """The fused chain, one warp per event; contract of ``full_chain_step``.

    CUDA tensors (int16 waves (n, L), int32 lengths, float32 baselines,
    int8 polarity codes, all contiguous on one device) go through the
    kernel, ``tile_rows`` events per block; CPU tensors through the plain
    PyTorch version.
    """
    cfg = cfg or ChainConfig()
    if _devices(waves, event_length, baselines, polarity_codes) == "cpu":
        return full_chain_step(waves, event_length, baselines, polarity_codes, cfg)
    return _launch(waves, event_length, baselines, polarity_codes, cfg, tile_rows)


chain_tile_cuda.launches = 0  # kernel launches (not plain-version calls)


def make_chain_tile(cfg: Optional[ChainConfig] = None, tile_rows: int = DEFAULT_TILE_ROWS):
    """The tile chain as a step function of the four batch tensors (the
    counterpart of the JAX package's make_jit_chain_pallas)."""
    cfg = cfg or ChainConfig()
    _check_tile_rows(tile_rows)

    def step(waves, event_length, baselines, polarity_codes):
        return chain_tile_cuda(waves, event_length, baselines, polarity_codes, cfg,
                               tile_rows=tile_rows)

    return step
