"""Streaming-scan kernels of the chain, hand-written in CUDA.

Port of ``waveformanalysis_tpu/ops/chain_scan_pallas.py``:

- ``chain_scan_cuda`` / ``make_chain_scan`` (``csrc/chain_scan.cu``): the
  fused chain, the same 12 per-event outputs as ``full_chain_step``,
  ``label`` as int8, and the two int32 overflow scalars derived from the
  raw per-event candidate/run counts;
- ``find_peaks_scan`` (``csrc/peaks_scan.cu``): scipy-parity find_peaks,
  the contract of ``ops.peaks.find_peaks_batch`` without a neighbour
  threshold;
- ``threshold_hits_scan`` (``csrc/hits_scan.cu``): threshold runs, the
  contract of ``ops.hits.threshold_hits_batch``.

All three kernels run one warp per event on the event-major rows the
caller formed, with no transposing copy; ``row_layout`` (shared with
``width_crossings_scan``) gives each its events per block, shared memory and
row copies, and the chain kernel shares the find_peaks and threshold-run
passes of the other two (``csrc/warp_peaks.cuh``, ``csrc/warp_hits.cuh``).

On CUDA tensors each wrapper launches its kernel or raises; on CPU tensors
it runs the plain PyTorch version named above, which is the contract the
kernel is held to. The scan kernels agree with their plain versions on
every slot the ``valid`` mask selects and on positions, validity and
counts everywhere; values in slots that are not valid are not part of the
contract (the JAX package's tests compare them the same way).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from waveformanalysis_tpu_torch.kernels._build import count_launch
from waveformanalysis_tpu_torch.models.full_chain import ChainConfig, full_chain_step
from waveformanalysis_tpu_torch.ops.hits import threshold_hits_batch
from waveformanalysis_tpu_torch.ops.peaks import find_peaks_batch
from waveformanalysis_tpu_torch.ops.widths import _BASELINE_SAMPLES

MAX_SLOTS = 32  # largest max_peaks / max_hits the kernel is instantiated for
_HEIGHT_EXT = 4  # full_chain_step's peak_heights_batch window_extension


class _Params(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in (
        "n", "L", "K", "K_hits", "height_start", "height_end", "area_start",
        "peak_distance", "use_derivative", "left_extension",
        "right_extension", "height_ext", "baseline_samples",
    )] + [(f, ctypes.c_float) for f in (
        "peak_height", "peak_prominence", "peak_width", "rel_height",
        "hit_threshold", "rise_low", "rise_high", "s1_width_max",
        "s2_width_min",
    )]


# kernel output name -> dtype, in the C struct's field order
_OUTS = (
    ("height", torch.float32), ("amp", torch.float32),
    ("area", torch.float32), ("max_abs_diff", torch.float32),
    ("peak_position", torch.int32), ("n_peaks", torch.int32),
    ("n_hits", torch.int32), ("hit_integral", torch.float32),
    ("rise_samples", torch.float32), ("fall_samples", torch.float32),
    ("width_samples", torch.float32), ("label", torch.int8),
    ("n_candidates", torch.int32), ("n_runs", torch.int32),
)


class _Outs(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name, _ in _OUTS]


def _scan_library(name: str, entry: str, argtypes) -> ctypes.CDLL:
    """Build (at first use) ``csrc/<name>.cu`` and bind ``entry``."""
    from waveformanalysis_tpu_torch.kernels._build import build

    lib = build(name).lib
    fn = getattr(lib, entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib


def _library() -> ctypes.CDLL:
    return _scan_library("chain_scan", "wfa_chain_scan", [ctypes.c_void_p] * 4 + [
        ctypes.POINTER(_Outs), ctypes.POINTER(_Params), ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ])


def _devices(*ts) -> str:
    """"cpu" or "cuda": the one device type of the given tensors (None
    skipped); raises for mixed or other devices."""
    devices = {t.device.type for t in ts if t is not None}
    if len(devices) != 1 or devices - {"cpu", "cuda"}:
        raise ValueError(f"expected CPU or CUDA tensors on one device type, got {sorted(devices)}")
    return devices.pop()


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _params(cfg: ChainConfig, n: int, L: int) -> _Params:
    hs, he = cfg.height_range
    return _Params(
        n=n, L=L, K=int(cfg.max_peaks), K_hits=int(cfg.max_hits),
        height_start=int(hs), height_end=min(int(he), L),
        area_start=int(cfg.area_start), peak_distance=int(cfg.peak_distance),
        use_derivative=int(bool(cfg.use_derivative)),
        left_extension=int(cfg.left_extension),
        right_extension=int(cfg.right_extension),
        height_ext=_HEIGHT_EXT, baseline_samples=_BASELINE_SAMPLES,
        peak_height=cfg.peak_height, peak_prominence=cfg.peak_prominence,
        peak_width=cfg.peak_width, rel_height=0.5,
        hit_threshold=cfg.hit_threshold, rise_low=cfg.rise_low,
        rise_high=cfg.rise_high, s1_width_max=cfg.s1_width_max,
        s2_width_min=cfg.s2_width_min,
    )


def check_chain_batch(waves, event_length, baselines, polarity_codes, cfg: ChainConfig) -> None:
    """The checks both CUDA chain kernels (K1 here, K7 in chain_tile_cuda)
    make before anything is built: dtypes, shapes, contiguity, one device,
    1..32 slots and 2 <= L < 65536 (the int32 area sum is exact below)."""
    n, L = waves.shape
    dev = waves.device
    _check(waves, "waves", torch.int16, (n, L), dev)
    _check(event_length, "event_length", torch.int32, (n,), dev)
    _check(baselines, "baselines", torch.float32, (n,), dev)
    _check(polarity_codes, "polarity_codes", torch.int8, (n,), dev)
    if not (1 <= cfg.max_peaks <= MAX_SLOTS and 1 <= cfg.max_hits <= MAX_SLOTS):
        raise ValueError(
            f"max_peaks={cfg.max_peaks} / max_hits={cfg.max_hits}: the CUDA "
            f"chain kernels hold 1..{MAX_SLOTS} slots"
        )
    if not 2 <= L < 65536:
        raise ValueError(f"wave length {L}: the CUDA chain kernels take 2 <= L < 65536")


def chain_outputs(n: int, dev) -> Dict[str, torch.Tensor]:
    """Empty per-event output tensors of the chain kernels, in _OUTS order."""
    return {name: torch.empty(n, dtype=dt, device=dev) for name, dt in _OUTS}


def with_overflow(outs: Dict[str, torch.Tensor], cfg: ChainConfig) -> Dict[str, torch.Tensor]:
    """Replace the raw per-event candidate / run counts by the two int32
    overflow scalars of the full_chain_step contract."""
    n_cand = outs.pop("n_candidates")
    n_runs = outs.pop("n_runs")
    outs["n_peak_overflow"] = (n_cand > cfg.max_peaks).sum(dtype=torch.int32)
    outs["n_hit_overflow"] = (n_runs > cfg.max_hits).sum(dtype=torch.int32)
    return outs


def _launch(waves, event_length, baselines, polarity_codes, cfg) -> Dict[str, torch.Tensor]:
    check_chain_batch(waves, event_length, baselines, polarity_codes, cfg)
    n, L = waves.shape
    dev = waves.device
    lay = row_layout(L, 2, waves.data_ptr(), CHAIN_SLOT_BYTES)  # staged: L < 65536
    lib = _library()
    with torch.cuda.device(dev):
        outs = chain_outputs(n, dev)
        ptrs = _Outs(*(outs[name].data_ptr() for name, _ in _OUTS))
        prm = _params(cfg, n, L)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.wfa_chain_scan(
            waves.data_ptr(), event_length.data_ptr(), baselines.data_ptr(),
            polarity_codes.data_ptr(), ctypes.byref(ptrs), ctypes.byref(prm),
            lay.rows, int(lay.vec), stream,
        )
    if err != 0:
        raise RuntimeError(f"chain_scan kernel launch failed: cudaError {err}")
    if n:  # the C entry launches nothing for an empty batch
        count_launch(chain_scan_cuda)
    return with_overflow(outs, cfg)


def chain_scan_cuda(
    waves: torch.Tensor,
    event_length: torch.Tensor,
    baselines: torch.Tensor,
    polarity_codes: torch.Tensor,
    cfg: Optional[ChainConfig] = None,
) -> Dict[str, torch.Tensor]:
    """The fused chain; contract of ``full_chain_step``.

    CUDA tensors (int16 waves (n, L), int32 lengths, float32 baselines,
    int8 polarity codes, all contiguous on one device) go through the
    kernel; CPU tensors through the plain PyTorch version.
    """
    cfg = cfg or ChainConfig()
    if _devices(waves, event_length, baselines, polarity_codes) == "cpu":
        return full_chain_step(waves, event_length, baselines, polarity_codes, cfg)
    return _launch(waves, event_length, baselines, polarity_codes, cfg)


chain_scan_cuda.launches = 0  # kernel launches (not plain-version calls)


def make_chain_scan(cfg: Optional[ChainConfig] = None):
    """The chain as a step function of the four batch tensors (the
    counterpart of the JAX package's make_jit_chain_scan)."""
    cfg = cfg or ChainConfig()

    def step(waves, event_length, baselines, polarity_codes):
        return chain_scan_cuda(waves, event_length, baselines, polarity_codes, cfg)

    return step


# ---------------------------------------------------------------------------
# The warp-per-event row layout of K1-K4 (csrc/warp_rows.cuh)
# ---------------------------------------------------------------------------

SMEM_BYTES = 232_448  # shared memory one block can use on the H100
ROW_WARPS = 8  # events (warps) per block of the warp-per-event kernels
PEAK_SLOT_BYTES = 2 * 32 * 4  # K2's per-warp candidate position / value tables
HIT_SLOT_BYTES = 2 * 32 * 4  # K3's per-warp run start / end tables
CHAIN_SLOT_BYTES = PEAK_SLOT_BYTES + HIT_SLOT_BYTES  # K1 holds both


@dataclass(frozen=True)
class RowLayout:
    """How a warp-per-event kernel holds its rows (``csrc/warp_rows.cuh``)."""

    rows: int  # events (warps) per block
    smem_bytes: int  # dynamic shared memory per block
    staged: bool  # rows copied to shared memory; False: read from global memory
    vec: bool  # 16-byte row copies (rows and base 16-byte aligned)


def row_bytes(L: int, elem: int) -> int:
    """Shared-memory bytes of one staged row of L elements of ``elem``
    bytes, padded to 16 (``wfa::row_bytes``)."""
    return (L * elem + 15) // 16 * 16


def row_layout(L: int, elem: int, base_ptr: int, slot_bytes: int = 0) -> RowLayout:
    """The layout for rows of L elements of ``elem`` bytes starting at
    address ``base_ptr``: ROW_WARPS events per block where they fit, fewer
    where they do not, and rows read from global memory where one row and
    ``slot_bytes`` of per-warp tables exceed a block's shared memory."""
    per_warp = row_bytes(L, elem) + slot_bytes
    if per_warp > SMEM_BYTES:  # long rows
        return RowLayout(ROW_WARPS, ROW_WARPS * slot_bytes, False, False)
    rows = min(ROW_WARPS, SMEM_BYTES // per_warp)
    vec = (L * elem) % 16 == 0 and base_ptr % 16 == 0
    return RowLayout(rows, rows * per_warp, True, vec)


def max_staged_length(elem: int, slot_bytes: int = 0) -> int:
    """The longest row that is still staged in shared memory."""
    return (SMEM_BYTES - slot_bytes) // 16 * 16 // elem


# ---------------------------------------------------------------------------
# find_peaks_scan (csrc/peaks_scan.cu)
# ---------------------------------------------------------------------------

class _PeaksParams(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in ("n", "L", "K", "distance")] + [
        (f, ctypes.c_float) for f in ("height", "prominence", "width", "rel_height")
    ]


# output name -> dtype, in the C struct's field order (per-slot tables first)
_PEAKS_OUTS = (
    ("position", torch.int32), ("valid", torch.bool),
    ("peak_value", torch.float32), ("prominence", torch.float32),
    ("left_ips", torch.float32), ("right_ips", torch.float32),
    ("widths", torch.float32), ("left_bases", torch.int32),
    ("right_bases", torch.int32), ("n_candidates", torch.int32),
)


class _PeaksOut(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name, _ in _PEAKS_OUTS]


def _peaks_library() -> ctypes.CDLL:
    return _scan_library("peaks_scan", "wfa_peaks_scan", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(_PeaksOut),
        ctypes.POINTER(_PeaksParams)] + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _tables(specs, n: int, K: int, dev) -> Dict[str, torch.Tensor]:
    """Output tensors: (n, K) slot tables, (n,) for the last (count) entry."""
    out = {name: torch.empty((n, K), dtype=dt, device=dev) for name, dt in specs[:-1]}
    name, dt = specs[-1]
    out[name] = torch.empty(n, dtype=dt, device=dev)
    return out


def find_peaks_scan(
    signal: torch.Tensor,
    height: float,
    prominence: float,
    width: float,
    distance: int = 1,
    max_peaks: int = 8,
    rel_height: float = 0.5,
    valid_length: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """find_peaks over an (n, L) batch (contract of
    ``chain_scan_pallas.find_peaks_scan``).

    Returns (n, K) tables position (int32, -1 where not valid), valid
    (bool), peak_value, prominence, left_ips, right_ips, widths (float32),
    left_bases, right_bases (int32), and n_candidates (n,) int32. CUDA
    tensors go through the kernel, CPU tensors through ``find_peaks_batch``.
    """
    if _devices(signal, valid_length) == "cpu":
        return find_peaks_batch(
            signal, height, prominence, width, distance=distance,
            max_peaks=max_peaks, rel_height=rel_height, valid_length=valid_length,
        )
    x = signal.to(torch.float32).contiguous()  # event-major, as the caller formed it
    n, L = x.shape
    K = int(max_peaks)
    dev = x.device
    if not 1 <= K <= MAX_SLOTS:
        raise ValueError(f"max_peaks={K}: the CUDA peaks kernel holds 1..{MAX_SLOTS} slots")
    vlen = (torch.full((n,), L, dtype=torch.int32, device=dev) if valid_length is None
            else valid_length.to(torch.int32).contiguous())
    _check(vlen, "valid_length", torch.int32, (n,), dev)
    lay = row_layout(L, 4, x.data_ptr(), PEAK_SLOT_BYTES)
    lib = _peaks_library()
    with torch.cuda.device(dev):
        outs = _tables(_PEAKS_OUTS, n, K, dev)
        ptrs = _PeaksOut(*(outs[name].data_ptr() for name, _ in _PEAKS_OUTS))
        prm = _PeaksParams(n=n, L=L, K=K, distance=int(distance), height=height,
                           prominence=prominence, width=width, rel_height=rel_height)
        err = lib.wfa_peaks_scan(x.data_ptr(), vlen.data_ptr(), ctypes.byref(ptrs),
                                 ctypes.byref(prm), lay.rows, int(lay.staged), int(lay.vec),
                                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"peaks_scan kernel launch failed: cudaError {err}")
    if n:
        count_launch(find_peaks_scan)
    return outs


find_peaks_scan.launches = 0  # kernel launches (not plain-version calls)


# ---------------------------------------------------------------------------
# threshold_hits_scan (csrc/hits_scan.cu)
# ---------------------------------------------------------------------------

class _HitsParams(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int) for f in
                ("n", "L", "K", "left_extension", "right_extension")]


_HITS_OUTS = (
    ("valid", torch.bool), ("position", torch.int32),
    ("height", torch.float32), ("integral", torch.float32),
    ("seg_start", torch.int32), ("seg_end", torch.int32),
    ("run_start", torch.int32), ("run_end", torch.int32),
    ("n_runs", torch.int32),
)


class _HitsOut(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name, _ in _HITS_OUTS]


def _hits_library() -> ctypes.CDLL:
    return _scan_library("hits_scan", "wfa_hits_scan", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(_HitsOut), ctypes.POINTER(_HitsParams)] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p])


def threshold_hits_scan(
    signal: torch.Tensor,
    thresholds: torch.Tensor,
    valid_length: torch.Tensor,
    left_extension: int = 2,
    right_extension: int = 2,
    max_hits: int = 8,
) -> Dict[str, torch.Tensor]:
    """Threshold runs over an (n, L) batch (contract of
    ``chain_scan_pallas.threshold_hits_scan``).

    Returns (n, K) tables valid (bool), position (int32), height, integral
    (float32), seg_start, seg_end, run_start, run_end (int32), and n_runs
    (n,) int32. CUDA tensors go through the kernel, CPU tensors through
    ``threshold_hits_batch``.
    """
    if _devices(signal, thresholds, valid_length) == "cpu":
        return threshold_hits_batch(
            signal, thresholds, valid_length, left_extension=left_extension,
            right_extension=right_extension, max_hits=max_hits,
        )
    x = signal.to(torch.float32).contiguous()  # event-major, as the caller formed it
    n, L = x.shape
    K = int(max_hits)
    dev = x.device
    if K < 1:
        raise ValueError(f"max_hits={K}: need at least one slot")
    thr = thresholds.to(torch.float32).contiguous()
    vlen = valid_length.to(torch.int32).contiguous()
    _check(thr, "thresholds", torch.float32, (n,), dev)
    _check(vlen, "valid_length", torch.int32, (n,), dev)
    lay = row_layout(L, 4, x.data_ptr(), HIT_SLOT_BYTES)
    lib = _hits_library()
    with torch.cuda.device(dev):
        outs = _tables(_HITS_OUTS, n, K, dev)
        ptrs = _HitsOut(*(outs[name].data_ptr() for name, _ in _HITS_OUTS))
        prm = _HitsParams(n=n, L=L, K=K, left_extension=int(left_extension),
                          right_extension=int(right_extension))
        err = lib.wfa_hits_scan(x.data_ptr(), thr.data_ptr(), vlen.data_ptr(),
                                ctypes.byref(ptrs), ctypes.byref(prm), lay.rows,
                                int(lay.staged), int(lay.vec),
                                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hits_scan kernel launch failed: cudaError {err}")
    if n:
        count_launch(threshold_hits_scan)
    return outs


threshold_hits_scan.launches = 0  # kernel launches (not plain-version calls)
