"""Streaming-scan kernels of the chain, hand-written in CUDA.

Port of ``waveformanalysis_tpu/ops/chain_scan_pallas.py``:

- ``chain_scan_cuda`` / ``make_chain_scan`` (``csrc/chain_scan.cu``): the
  fused chain, the same 12 per-event outputs as ``full_chain_step``,
  ``label`` as int8, and the two int32 overflow counters, which the kernel
  counts itself; ``make_sharded_chain_scan`` runs it on every shard of a
  device mesh;
- ``find_peaks_scan`` (``csrc/peaks_scan.cu``): scipy-parity find_peaks,
  the contract of ``ops.peaks.find_peaks_batch`` without a neighbour
  threshold;
- ``threshold_hits_scan`` (``csrc/hits_scan.cu``): threshold runs, the
  contract of ``ops.hits.threshold_hits_batch``.

All three kernels run one warp per event on the event-major rows the
caller formed, with no transposing copy; ``row_layout`` (shared with
``width_crossings_scan``) gives each its events per block, shared memory and
row copies. The chain kernel takes one of two paths, which
``chain_layout`` picks by the wave length: rows of L <= 256 samples in the
warp's registers, R = 1, 2, 4 or 8 contiguous samples a lane
(``csrc/warp_chain_regs.cuh``), longer rows staged in shared memory, where
it shares the find_peaks and threshold-run passes of the other two
(``csrc/warp_chain.cuh``, ``csrc/warp_peaks.cuh``, ``csrc/warp_hits.cuh``).

On CUDA tensors each wrapper launches its kernel or raises; on CPU tensors
it runs the plain PyTorch version named above, which is the contract the
kernel is held to. A chain step is one memset and one launch: its outputs
are typed views of one fresh allocation (``chain_outputs``), and what
depends only on the batch's shape, alignment and config is kept in a launch
plan (``_launch``). The scan kernels agree with their plain versions on
every slot the ``valid`` mask selects and on positions, validity and
counts everywhere; values in slots that are not valid are not part of the
contract (the JAX package's tests compare them the same way).
"""

from __future__ import annotations

import ctypes
import operator
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from waveformanalysis_tpu_torch.kernels._build import count_launch
from waveformanalysis_tpu_torch.models.full_chain import (
    ChainConfig,
    full_chain_step,
    sharded_chain,
)
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


# kernel output name -> dtype, in the C struct's field order: the 12
# per-event outputs, then the two overflow counters (0-d) the kernel adds
# each event's flags into
_OUTS = (
    ("height", torch.float32), ("amp", torch.float32),
    ("area", torch.float32), ("max_abs_diff", torch.float32),
    ("peak_position", torch.int32), ("n_peaks", torch.int32),
    ("n_hits", torch.int32), ("hit_integral", torch.float32),
    ("rise_samples", torch.float32), ("fall_samples", torch.float32),
    ("width_samples", torch.float32), ("label", torch.int8),
    ("n_peak_overflow", torch.int32), ("n_hit_overflow", torch.int32),
)
_NAMES = tuple(name for name, _ in _OUTS)


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
    lib = _scan_library("chain_scan", "wfa_chain_scan", [ctypes.c_void_p] * 4 + [
        ctypes.POINTER(_Outs), ctypes.POINTER(_Params), ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ])
    lib.wfa_chain_scan_regs.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.POINTER(_Outs), ctypes.POINTER(_Params)] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.wfa_chain_scan_regs.restype = ctypes.c_int
    lib.wfa_chain_scan_warps_per_sm.argtypes = [ctypes.c_int] * 4
    lib.wfa_chain_scan_warps_per_sm.restype = ctypes.c_int
    return lib


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


def check_chain_inputs(waves, event_length, baselines, polarity_codes) -> None:
    """The chain kernels' checks of the four batch tensors: dtypes, shapes,
    contiguity, one device."""
    n, L = waves.shape
    dev = waves.device
    _check(waves, "waves", torch.int16, (n, L), dev)
    _check(event_length, "event_length", torch.int32, (n,), dev)
    _check(baselines, "baselines", torch.float32, (n,), dev)
    _check(polarity_codes, "polarity_codes", torch.int8, (n,), dev)


def _inputs_ok(waves, event_length, baselines, polarity_codes, n: int, dev) -> bool:
    """check_chain_inputs as one predicate, for a good batch's fast path
    (False: check_chain_inputs names the fault)."""
    return (waves.dtype == torch.int16 and event_length.dtype == torch.int32
            and baselines.dtype == torch.float32 and polarity_codes.dtype == torch.int8
            and waves.is_contiguous() and event_length.is_contiguous()
            and baselines.is_contiguous() and polarity_codes.is_contiguous()
            and event_length.shape == baselines.shape == polarity_codes.shape == (n,)
            and event_length.device == baselines.device == polarity_codes.device == dev)


def check_chain_config(L: int, cfg: ChainConfig) -> None:
    """The chain kernels' limits: 1..32 slots and 2 <= L < 65536 (the int32
    area sum is exact below)."""
    if not (1 <= cfg.max_peaks <= MAX_SLOTS and 1 <= cfg.max_hits <= MAX_SLOTS):
        raise ValueError(
            f"max_peaks={cfg.max_peaks} / max_hits={cfg.max_hits}: the CUDA "
            f"chain kernels hold 1..{MAX_SLOTS} slots"
        )
    if not 2 <= L < 65536:
        raise ValueError(f"wave length {L}: the CUDA chain kernels take 2 <= L < 65536")


def check_chain_batch(waves, event_length, baselines, polarity_codes, cfg: ChainConfig) -> None:
    """The checks both CUDA chain kernels (K1 here, K7 in chain_tile_cuda)
    make before anything is built: check_chain_inputs, then
    check_chain_config."""
    check_chain_inputs(waves, event_length, baselines, polarity_codes)
    check_chain_config(waves.shape[1], cfg)


# the per-event outputs in the order they lie in the outputs' allocation:
# the float32 ones, the int32 ones, then label
_FLOATS = tuple(name for name, dt in _OUTS[:12] if dt == torch.float32)
_INTS = tuple(name for name, dt in _OUTS[:12] if dt == torch.int32)
_ROWS = _FLOATS + _INTS + ("label",)
# _OUTS order as indices into _out_views' parts (_ROWS, then the counters)
_PICK = operator.itemgetter(*[(_ROWS + _NAMES[12:]).index(name) for name in _NAMES])


def _out_layout(n: int) -> Tuple[int, Tuple[int, ...]]:
    """The one allocation that holds a batch's outputs: its int32 words and
    the byte offset of each _OUTS field in it. The 4-byte per-event outputs
    come first, n each in _ROWS order, then label (n int8), then the two
    counters at the next 8-byte boundary, adjacent, as the C entries' one
    memset takes them: 45 n + 8 bytes, and at most 7 of padding."""
    ctr = (45 * n + 7) // 8 * 8
    at = {name: 4 * n * k for k, name in enumerate(_ROWS)}
    return ctr // 4 + 2, tuple(at[name] for name in _NAMES[:12]) + (ctr, ctr + 4)


def _out_views(buf: torch.Tensor, n: int) -> Dict[str, torch.Tensor]:
    """The _OUTS fields as typed views of ``buf`` (int32, _out_layout's
    words): (n,) per-event outputs and 0-d counters, in _OUTS order. One
    strided view and one unbind a dtype: every view costs host time."""
    nf, ni = len(_FLOATS), len(_INTS)
    parts = (buf.view(torch.float32).as_strided((nf, n), (n, 1)).unbind(0)
             + buf.as_strided((ni, n), (n, 1), nf * n).unbind(0)
             + (buf.view(torch.int8).as_strided((n,), (1,), 4 * (nf + ni) * n),)
             + buf.as_strided((2,), (1,), buf.numel() - 2).unbind(0))
    return dict(zip(_NAMES, _PICK(parts)))


def chain_outputs(n: int, dev) -> Dict[str, torch.Tensor]:
    """Outputs of the chain kernels for n events, in _OUTS order: views of
    one fresh allocation, left empty (the C entries zero the counters)."""
    return _out_views(torch.empty(_out_layout(n)[0], dtype=torch.int32, device=dev), n)


def no_events(dev) -> Dict[str, torch.Tensor]:
    """The chain's outputs for an empty batch, which launches nothing: no
    events, both counters 0."""
    return _out_views(torch.zeros(_out_layout(0)[0], dtype=torch.int32, device=dev), 0)


def out_pointers(buf: torch.Tensor, offsets: Tuple[int, ...]) -> "_Outs":
    """The C struct of the outputs held in ``buf`` at ``offsets``
    (_out_layout)."""
    base = buf.data_ptr()
    return _Outs(*[base + o for o in offsets])


# ---------------------------------------------------------------------------
# The chain kernel's two paths (csrc/chain_scan.cu)
# ---------------------------------------------------------------------------

REG_SAMPLES = (1, 2, 4, 8)  # samples a lane of the register path holds
REG_MAX_LENGTH = 32 * REG_SAMPLES[-1]  # the longest row the register path takes
REG_ROWS = 4  # events (warps) per block of the register path (4 ran ahead of 8 and 2)


@dataclass(frozen=True)
class ChainLayout:
    """How the chain kernel holds an event's row (``csrc/chain_scan.cu``)."""

    path: str  # "register" (L <= REG_MAX_LENGTH) or "staged" (shared memory)
    R: int  # samples a lane on the register path; 0 on the staged path
    rows: int  # events (warps) per block
    smem_bytes: int  # dynamic shared memory per block
    vec: bool  # 16-byte aligned rows of L % 8 == 0: vector loads / cp.async


def reg_samples(L: int) -> int:
    """Samples a lane holds on the register path: ceil(L / 32) rounded up
    to 1, 2, 4 or 8; 0 for rows longer than REG_MAX_LENGTH."""
    return next((r for r in REG_SAMPLES if 32 * r >= L), 0)


def reg_warp_bytes(R: int, deriv: bool) -> int:
    """Shared memory one warp of the register path takes
    (``wfa::reg_warp_bytes``): the float32 signal of 32 R samples, the
    detection values beside it with use_derivative, and the slot tables."""
    return 32 * R * 4 * (2 if deriv else 1) + CHAIN_SLOT_BYTES


def chain_layout(L: int, base_ptr: int, deriv: bool) -> ChainLayout:
    """The chain kernel's path for rows of L samples starting at address
    ``base_ptr``: the register path for L <= REG_MAX_LENGTH, else the
    staged path of ``row_layout`` (the int16 row in shared memory, every
    L < 65536)."""
    R = reg_samples(L)
    if R:
        return ChainLayout("register", R, REG_ROWS, REG_ROWS * reg_warp_bytes(R, deriv),
                           L % 8 == 0 and base_ptr % 16 == 0)
    lay = row_layout(L, 2, base_ptr, CHAIN_SLOT_BYTES)
    return ChainLayout("staged", 0, lay.rows, lay.smem_bytes, lay.vec)


def _bind(lib, lay: ChainLayout, prm: "_Params") -> Callable[..., int]:
    """The chain kernel's C entry for layout ``lay`` with ``prm`` and the
    layout bound: a function of the four input pointers, ``byref`` of the
    output struct and the stream, returning the cudaError_t of the launch."""
    p = ctypes.byref(prm)  # holds prm
    rows, vec = lay.rows, int(lay.vec)
    if lay.path == "register":
        fn, R, smem = lib.wfa_chain_scan_regs, lay.R, lay.smem_bytes
        return lambda w, el, bl, pol, outs, s: fn(w, el, bl, pol, outs, p, rows, R, vec, smem, s)
    fn = lib.wfa_chain_scan
    return lambda w, el, bl, pol, outs, s: fn(w, el, bl, pol, outs, p, rows, vec, s)


def launch_chain(lib, lay: ChainLayout, waves: int, event_length: int, baselines: int,
                 polarity_codes: int, outs: "_Outs", prm: "_Params", stream) -> int:
    """Launch the chain kernel of layout ``lay`` on the given device
    pointers (the counters zeroed first); the cudaError_t of the launch (0 =
    success)."""
    return _bind(lib, lay, prm)(waves, event_length, baselines, polarity_codes,
                                ctypes.byref(outs), stream)


def chain_warps_per_sm(lay: ChainLayout, deriv: bool) -> int:
    """Warps of the chain kernel of layout ``lay`` one SM holds
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); on the card."""
    warps = _library().wfa_chain_scan_warps_per_sm(lay.R, int(deriv), lay.rows, lay.smem_bytes)
    if warps < 0:
        raise RuntimeError(f"chain_scan occupancy query failed: cudaError {-warps}")
    return warps


@dataclass(frozen=True)
class _Plan:
    """What a launch of K1 takes besides the batch's pointers, for one
    (device, n, L, 16-byte alignment of the rows' base, cfg)."""

    cfg: ChainConfig  # held, so that no other config takes its id in the key
    words: int  # int32 words of the outputs' allocation (_out_layout)
    offsets: Tuple[int, ...]  # byte offsets of the _OUTS fields in it
    launch: Callable[..., int]  # _bind's C entry
    counter: str  # the launch count of the layout's path


_PLANS: Dict[tuple, _Plan] = {}
MAX_PLANS = 64  # launch plans kept; a full cache starts afresh


def _plan(cfg: ChainConfig, n: int, L: int, base_ptr: int) -> _Plan:
    check_chain_config(L, cfg)
    lay = chain_layout(L, base_ptr, bool(cfg.use_derivative))
    words, offsets = _out_layout(n)
    return _Plan(cfg, words, offsets, _bind(_library(), lay, _params(cfg, n, L)),
                 f"{lay.path}_launches")


def _stream(dev) -> int:
    """The handle of ``dev``'s current stream, without the Stream object
    ``torch.cuda.current_stream`` builds (0.2 against 7.0 us a call on the
    host of an NVIDIA H100 machine; the call torch's generated kernels
    make)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def _launch(waves, event_length, baselines, polarity_codes, cfg) -> Dict[str, torch.Tensor]:
    """One memset and one launch on the current stream: the checks, the
    launch plan (cached by device, shape, alignment and the config object),
    one allocation for the outputs, the pointer struct."""
    n, L = waves.shape
    dev = waves.device
    if not _inputs_ok(waves, event_length, baselines, polarity_codes, n, dev):
        check_chain_inputs(waves, event_length, baselines, polarity_codes)
    w = waves.data_ptr()
    if not n:
        check_chain_config(L, cfg)
        return no_events(dev)
    key = (dev, n, L, w % 16 == 0, id(cfg))
    plan = _PLANS.get(key)
    hit = plan is not None
    if not hit:
        plan = _plan(cfg, n, L, w)
        if len(_PLANS) >= MAX_PLANS:
            _PLANS.clear()
        _PLANS[key] = plan
    buf = torch.empty(plan.words, dtype=torch.int32, device=dev)
    args = (w, event_length.data_ptr(), baselines.data_ptr(), polarity_codes.data_ptr(),
            ctypes.byref(out_pointers(buf, plan.offsets)))
    if dev.index == torch.cuda.current_device():
        err = plan.launch(*args, _stream(dev))
    else:
        with torch.cuda.device(dev):
            err = plan.launch(*args, _stream(dev))
    if err != 0:
        raise RuntimeError(f"chain_scan kernel launch failed: cudaError {err}")
    count_launch(chain_scan_cuda, plan.counter, "plan_hits" if hit else "plan_misses")
    return _out_views(buf, n)


_DEFAULT_CONFIG = ChainConfig()


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
    kernel; CPU tensors through the plain PyTorch version. The outputs are
    views of one allocation, fresh each call.
    """
    cfg = cfg or _DEFAULT_CONFIG
    if waves.is_cuda or _devices(waves, event_length, baselines, polarity_codes) != "cpu":
        return _launch(waves, event_length, baselines, polarity_codes, cfg)
    return full_chain_step(waves, event_length, baselines, polarity_codes, cfg)


chain_scan_cuda.launches = 0  # kernel launches (not plain-version calls)
chain_scan_cuda.register_launches = 0  # of them, on the register path (L <= 256)
chain_scan_cuda.staged_launches = 0  # of them, on the staged path (longer rows)
chain_scan_cuda.plan_hits = 0  # of them, with a cached launch plan
chain_scan_cuda.plan_misses = 0  # of them, with a plan made for the call


def make_chain_scan(cfg: Optional[ChainConfig] = None):
    """The chain as a step function of the four batch tensors (the
    counterpart of the JAX package's make_jit_chain_scan)."""
    cfg = cfg or ChainConfig()

    def step(waves, event_length, baselines, polarity_codes):
        return chain_scan_cuda(waves, event_length, baselines, polarity_codes, cfg)

    return step


def make_sharded_chain_scan(mesh, cfg: Optional[ChainConfig] = None, axis: str = "data"):
    """The chain kernel K1 on every shard of ``mesh``'s ``axis``, each launch
    on its shard's device (the counterpart of the JAX package's
    make_sharded_chain_scan); the output contract of
    ``models.full_chain.make_sharded_chain``."""
    return sharded_chain(mesh, make_chain_scan(cfg), axis)


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
