"""The fused chain through one hand-written CUDA kernel (``csrc/chain_scan.cu``).

Port of ``waveformanalysis_tpu/ops/chain_scan_pallas.py`` (``chain_scan_pallas``,
``make_jit_chain_scan``): the same 12 per-event outputs as
``full_chain_step``, ``label`` as int8, and the two int32 overflow scalars
derived from the raw per-event candidate/run counts.

On CUDA tensors the wrapper launches the kernel or raises; on CPU tensors
it runs the plain PyTorch version, ``models.full_chain.full_chain_step``,
which is the contract the kernel is held to.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from waveformanalysis_tpu_torch.models.full_chain import ChainConfig, full_chain_step
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


def _library() -> ctypes.CDLL:
    """Build (at first use) and bind the kernel library."""
    from waveformanalysis_tpu_torch.kernels._build import build

    lib = build("chain_scan").lib
    fn = lib.wfa_chain_scan
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.POINTER(_Outs), ctypes.POINTER(_Params), ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


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


def _launch(waves, event_length, baselines, polarity_codes, cfg) -> Dict[str, torch.Tensor]:
    n, L = waves.shape
    dev = waves.device
    _check(waves, "waves", torch.int16, (n, L), dev)
    _check(event_length, "event_length", torch.int32, (n,), dev)
    _check(baselines, "baselines", torch.float32, (n,), dev)
    _check(polarity_codes, "polarity_codes", torch.int8, (n,), dev)
    if not (1 <= cfg.max_peaks <= MAX_SLOTS and 1 <= cfg.max_hits <= MAX_SLOTS):
        raise ValueError(
            f"max_peaks={cfg.max_peaks} / max_hits={cfg.max_hits}: the CUDA "
            f"chain kernel holds 1..{MAX_SLOTS} slots"
        )
    if not 2 <= L < 65536:
        raise ValueError(f"wave length {L}: the CUDA chain kernel takes 2 <= L < 65536")

    lib = _library()
    with torch.cuda.device(dev):
        waves_t = waves.t().contiguous()  # time-major (L, n) copy on the device
        outs = {name: torch.empty(n, dtype=dt, device=dev) for name, dt in _OUTS}
        ptrs = _Outs(*(outs[name].data_ptr() for name, _ in _OUTS))
        prm = _params(cfg, n, L)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.wfa_chain_scan(
            waves_t.data_ptr(), event_length.data_ptr(), baselines.data_ptr(),
            polarity_codes.data_ptr(), ctypes.byref(ptrs), ctypes.byref(prm),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"chain_scan kernel launch failed: cudaError {err}")
    if n:  # the C entry launches nothing for an empty batch
        chain_scan_cuda.launches += 1
    n_cand = outs.pop("n_candidates")
    n_runs = outs.pop("n_runs")
    outs["n_peak_overflow"] = (n_cand > cfg.max_peaks).sum(dtype=torch.int32)
    outs["n_hit_overflow"] = (n_runs > cfg.max_hits).sum(dtype=torch.int32)
    return outs


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
    devices = {t.device.type for t in (waves, event_length, baselines, polarity_codes)}
    if devices == {"cpu"}:
        return full_chain_step(waves, event_length, baselines, polarity_codes, cfg)
    if devices == {"cuda"}:
        return _launch(waves, event_length, baselines, polarity_codes, cfg)
    raise ValueError(f"chain_scan_cuda takes CPU or CUDA tensors, got {sorted(devices)}")


chain_scan_cuda.launches = 0  # kernel launches (not plain-version calls)


def make_chain_scan(cfg: Optional[ChainConfig] = None):
    """The chain as a step function of the four batch tensors (the
    counterpart of the JAX package's make_jit_chain_scan)."""
    cfg = cfg or ChainConfig()

    def step(waves, event_length, baselines, polarity_codes):
        return chain_scan_cuda(waves, event_length, baselines, polarity_codes, cfg)

    return step
