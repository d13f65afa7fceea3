"""The tile-resident chain kernel, hand-written in CUDA.

Port of ``waveformanalysis_tpu/ops/chain_pallas.py``: ``chain_tile_cuda`` /
``make_chain_tile`` (``csrc/chain_tile.cu``) take the place of
``chain_pallas`` / ``make_jit_chain_pallas``, and ``make_sharded_chain_tile``
that of ``make_sharded_chain_pallas``. The contract is
``full_chain_step``'s: the same 12 per-event outputs, ``label`` as int8,
and the two int32 overflow counters, which the kernel counts itself, all
views of one allocation (``chain_scan_cuda.chain_outputs``).

The kernel reads the event-major ``(n, L)`` int16 waves as they are (no
transposing copy): one warp per event stages the row in shared memory,
writes the signal once into a float32 row beside it where that fits
(``tile_layout``), and runs the chain's warp passes on it
(``csrc/warp_chain.cuh``, which the chain kernel K1 runs on the int16 row
alone); ``tile_rows`` is the number of events (warps) per thread block.
The JAX package's ``interpret`` flag has no counterpart. On CUDA tensors
the wrapper launches the kernel or raises; on CPU tensors it runs the plain
version, ``full_chain_step`` (the function ``make_chain`` steps).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from waveformanalysis_tpu_torch.kernels._build import count_launch
from waveformanalysis_tpu_torch.models.full_chain import (
    ChainConfig,
    full_chain_step,
    sharded_chain,
)
from waveformanalysis_tpu_torch.ops.chain_scan_cuda import (
    CHAIN_SLOT_BYTES,
    SMEM_BYTES,
    _out_layout,
    _out_views,
    _Outs,
    _Params,
    _devices,
    _params,
    _scan_library,
    check_chain_batch,
    no_events,
    out_pointers,
    row_bytes,
)

DEFAULT_TILE_ROWS = 8  # events per block: 8 warps, 16 KB of shared memory at L = 256
MAX_TILE_ROWS = 32  # 1024 threads, the most a block holds
# the largest L the kernel takes: the chain's int32 area sum is exact below
# 65,536 (check_chain_batch); one int16 row of that length fits a block
MAX_WAVE_LENGTH = 65_535
# the longest row whose float32 signal row fits at all: one such event
# fills a block's shared memory
MAX_FLOAT_ROW_LENGTH = 38_656

# one H100 SM, for the occupancy both row modes reach (CUDA occupancy rules)
SM_SMEM_BYTES = 233_472  # 228 KB of shared memory an SM
SM_BLOCK_RESERVED = 1_024  # shared memory the system keeps per resident block
SM_WARPS = 64
SM_BLOCKS = 32
SM_REGISTERS = 65_536
# registers per thread of chain_tile_kernel, in both row modes (ptxas -v;
# chip_smoke.py fails if the build differs)
TILE_REGISTERS = 50


def event_smem_bytes(L: int, float_row: bool) -> int:
    """Shared memory one event takes (``wfa::chain_warp_bytes``): the int16
    row, the float32 signal row when ``float_row``, each padded to 16 bytes,
    and the four 32-entry slot tables."""
    return row_bytes(L, 2) + (row_bytes(L, 4) if float_row else 0) + CHAIN_SLOT_BYTES


@dataclass(frozen=True)
class TileLayout:
    """How the tile kernel holds its rows (``csrc/chain_tile.cu``)."""

    rows: int  # events (warps) per block
    float_row: bool  # the float32 signal row beside the int16 one
    smem_bytes: int  # dynamic shared memory per block


def _check_tile_rows(tile_rows: int) -> None:
    if not 1 <= tile_rows <= MAX_TILE_ROWS:
        raise ValueError(f"tile_rows={tile_rows}: the tile kernel takes 1..{MAX_TILE_ROWS}")


def warps_per_sm(lay: TileLayout) -> int:
    """Warps of the tile kernel resident on one SM with layout ``lay``:
    rows per block times the blocks that the SM's shared memory, warps,
    block slots and registers (TILE_REGISTERS a thread, allocated 256 a
    warp) all hold."""
    warp_regs = -(-TILE_REGISTERS * 32 // 256) * 256
    blocks = min(SM_BLOCKS, SM_WARPS // lay.rows, SM_REGISTERS // warp_regs // lay.rows,
                 SM_SMEM_BYTES // (lay.smem_bytes + SM_BLOCK_RESERVED))
    return lay.rows * blocks


def _layout(L: int, tile_rows: int, float_row: bool) -> TileLayout:
    per_event = event_smem_bytes(L, float_row)
    rows = min(tile_rows, SMEM_BYTES // per_event)
    return TileLayout(rows, float_row, rows * per_event)


def tile_layout(L: int, tile_rows: int) -> TileLayout:
    """The layout for rows of L samples, ``tile_rows`` events per block or
    fewer where that many do not fit: the float32 signal row where it keeps
    as many warps on an SM as the int16 row alone (it saves work per read,
    PERF.md), else the int16 row alone (the long-row mode, every L <=
    MAX_WAVE_LENGTH)."""
    _check_tile_rows(tile_rows)
    if L > MAX_WAVE_LENGTH:
        raise ValueError(f"wave length {L}: the tile kernel takes L <= {MAX_WAVE_LENGTH}")
    int16 = _layout(L, tile_rows, False)
    if L > MAX_FLOAT_ROW_LENGTH:
        return int16
    flt = _layout(L, tile_rows, True)
    return flt if warps_per_sm(flt) >= warps_per_sm(int16) else int16


def _library() -> ctypes.CDLL:
    return _scan_library("chain_tile", "wfa_chain_tile", [ctypes.c_void_p] * 4 + [
        ctypes.POINTER(_Outs), ctypes.POINTER(_Params)] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p])


def _launch(waves, event_length, baselines, polarity_codes, cfg,
            tile_rows) -> Dict[str, torch.Tensor]:
    check_chain_batch(waves, event_length, baselines, polarity_codes, cfg)
    n, L = waves.shape
    lay = tile_layout(L, tile_rows)
    dev = waves.device
    if not n:
        return no_events(dev)
    # 16-byte row loads where every row starts on a 16-byte boundary
    vec = int(L % 8 == 0 and waves.data_ptr() % 16 == 0)
    lib = _library()
    words, offsets = _out_layout(n)
    buf = torch.empty(words, dtype=torch.int32, device=dev)
    ptrs = out_pointers(buf, offsets)
    with torch.cuda.device(dev):
        prm = _params(cfg, n, L)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.wfa_chain_tile(
            waves.data_ptr(), event_length.data_ptr(), baselines.data_ptr(),
            polarity_codes.data_ptr(), ctypes.byref(ptrs), ctypes.byref(prm),
            lay.rows, vec, int(lay.float_row), stream,
        )
    if err != 0:
        raise RuntimeError(f"chain_tile kernel launch failed: cudaError {err}")
    count_launch(chain_tile_cuda)
    return _out_views(buf, n)


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


def make_sharded_chain_tile(mesh, cfg: Optional[ChainConfig] = None, axis: str = "data",
                            tile_rows: int = DEFAULT_TILE_ROWS):
    """The tile chain kernel K7 on every shard of ``mesh``'s ``axis``, each
    launch on its shard's device (the counterpart of the JAX package's
    make_sharded_chain_pallas); the output contract of
    ``models.full_chain.make_sharded_chain``."""
    return sharded_chain(mesh, make_chain_tile(cfg, tile_rows), axis)
