#!/usr/bin/env python3
"""Time the port's kernels in turns with a build of an earlier ``csrc/``, on
one NVIDIA GPU.

    git archive <commit> waveformanalysis_tpu_torch/csrc | tar -x -C build/parent
    python3 scripts/scan_kernel_turns.py --parent build/parent/waveformanalysis_tpu_torch/csrc \\
        [--kernels K1,K5] [--waves two_pulses]

For each named kernel the script builds ``DIR/<source>.cu`` (with the
headers beside it) with this checkout's nvcc flags and runs this checkout's
wrapper on that library and on this checkout's own build: the earlier side
only swaps the library behind the wrapper, so both sides run one host path
and only the kernels differ. The earlier sources must keep this checkout's C
entries and structs, which the wrappers bind as they are; a ``csrc/`` of
commit 6861ba1 or later has them all.

    K1  make_chain_scan's step       chain_scan.cu
    K2  find_peaks_scan              peaks_scan.cu
    K3  threshold_hits_scan          hits_scan.cu
    K4  width_crossings_scan         width_scan.cu
    K5  sosfiltfilt_cuda             sosfilt.cu
    K6  sosfilt_cuda, forward and in reverse
    K7  make_chain_tile's step       chain_tile.cu

On bench.py's waves (``make_batch(65536, 256, seed=0)``, repeated to
1,048,576 events; ``--waves two_pulses``: two narrow pulses a row, on which
K1's prominence screen runs on every row and takes no slot off the walks,
its worst case), with bench.py's chain config (K1, K7), at K = 32 with the
route's settings (K2-K4) and with route B's Butterworth design (K5, K6),
and for K1 and K7 also at the longer rows of ``LONG_ROWS`` (K1's staged
path; K7's float32 row at 1,024 and its int16 row alone at 4,096), the
script prints per kernel and size:

- both sides' wrapper outputs compared: integer outputs equal (else it
  fails), the largest f32 difference;
- the kernels alone on cold copies (more bytes than the 50 MB L2 holds),
  with preallocated outputs, as medians of CUDA-event timings over fresh
  inputs;
- the wrapper steps on the same cold copies;

both in turns (earlier, new, new, earlier), in one process on one card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from functools import partial
from pathlib import Path
from typing import Callable, Dict

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    F32_NONFMA_OPS_PER_S,
    bound,
    bound_at,
    check,
    median_ms,
    nbytes,
    sosfiltfilt_ops,
)
from waveformanalysis_tpu_torch.kernels import _build  # noqa: E402

K, L, N_BASE = 32, 256, 65_536
PEAKS_KW = dict(height=80.0, prominence=50.0, width=2.0, distance=2, max_peaks=K)
FRACS = (0.1, 0.9, 0.9, 0.1)
SOURCES = {"K1": "chain_scan", "K2": "peaks_scan", "K3": "hits_scan", "K4": "width_scan",
           "K5": "sosfilt", "K6": "sosfilt", "K7": "chain_tile"}
ROUTE_B_DESIGN = (4, 0.002, 0.1, 0.5)  # chip_smoke.FILTER_DESIGNS["route_b"]
LONG_ROWS = ((1_024, 262_144), (4_096, 65_536))  # (L, events): 512 MB of int16 waves each
SIDES = ("earlier", "new", "new", "earlier")


def two_pulse_batch(n: int, L: int, seed: int) -> np.ndarray:
    """(n, L) int16 rows, each two narrow pulses (sigma 3, 400 and 300 ADC
    high, L / 4 to L / 2 samples apart) on a 1000 baseline with noise sigma
    2: with the bench config every row keeps two slots and both reach the
    prominence, so K1's prominence screen runs on every row and takes none
    off the walks."""
    rng = np.random.default_rng(seed)
    t = np.arange(L)
    first = rng.integers(L // 8, 3 * L // 8, n)
    second = first + rng.integers(L // 4, L // 2, n)
    waves = 1000.0 + rng.normal(0, 2, (n, L))
    for c, amp in ((first, 400.0), (second, 300.0)):
        waves += amp * np.exp(-((t[None, :] - c[:, None]) ** 2) / (2 * 3.0 ** 2))
    return np.round(waves).astype(np.int16)



def build_earlier(parent: Path, name: str) -> _build.Built:
    """nvcc ``parent/<name>.cu`` with the port's flags into build/kernels."""
    src = parent / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(_build.NVCC_FLAGS).encode())
    for header in sorted(parent.glob("*.cuh")):
        digest.update(header.read_bytes())
    so = _build.BUILD_DIR / f"earlier_{name}_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)],
                              capture_output=True, text=True)
        check(proc.returncode == 0, f"nvcc {src}: {proc.stderr[-2000:]}")
    return _build.Built(lib=ctypes.CDLL(str(so)), path=so, log=so.with_suffix(".log"),
                        seconds=0.0)


class Sides:
    """Which build the wrappers load: this checkout's, or the earlier one."""

    def __init__(self, earlier: Dict[str, _build.Built]):
        self.build = {"earlier": earlier.__getitem__, "new": _build.build}

    def use(self, side: str) -> None:
        from waveformanalysis_tpu_torch.ops import chain_scan_cuda as csc

        _build.build = self.build[side]
        csc._PLANS.clear()  # K1's launch plans hold entries bound in a library


@dataclass
class Case:
    """One kernel at one size: the wrapper step on copy k, the kernel alone
    on copy k with a given library, and the wrapper's loader of it."""

    label: str
    step: Callable[[int], object]
    alone: Callable[[ctypes.CDLL], Callable[[int], None]]
    library: Callable[[], ctypes.CDLL]
    bound: str


def f32_gap(a, b) -> float:
    """Both sides' outputs: integers equal (checked), the largest f32
    difference (NaN in both places counts as equal)."""
    a, b = (x if isinstance(x, dict) else {"out": x} for x in (a, b))
    gap = 0.0
    for key in a:
        if not a[key].is_floating_point():
            check(torch.equal(a[key], b[key]), f"the integer output {key} differs")
        elif a[key].numel():
            d = torch.where(a[key].isnan() & b[key].isnan(), 0.0, (a[key] - b[key]).abs())
            gap = max(gap, float(d.nan_to_num(float("inf")).max()))
    return gap


def turns(sides: Sides, case: Case) -> None:
    outs, alone, names = {}, {}, []
    for side in SIDES[:2]:
        sides.use(side)
        outs[side] = case.step(0)
        lib = case.library()
        alone[side] = case.alone(lib)
        names.append(Path(lib._name).name)
    torch.cuda.synchronize()
    gap = f32_gap(outs["earlier"], outs["new"])
    del outs
    times: Dict[str, Dict[str, list]] = {"alone": {}, "steps": {}}
    for kind in times:
        for side in SIDES:
            sides.use(side)
            fn = alone[side] if kind == "alone" else case.step
            times[kind].setdefault(side, []).append(median_ms(fn))
    print(f"{case.label}: " + "; ".join(
        f"{kind}, " + ", ".join(f"{side} {' / '.join(f'{t:.3f}' for t in ts)} ms"
                                for side, ts in by_side.items())
        for kind, by_side in times.items())
        + f"; bound {case.bound}; integer outputs equal, f32 max |diff| {gap:.3g}; "
        f"libraries {' / '.join(names)}", flush=True)
    sides.use("new")


def chain_cases(kern: str, w, cfg, dev, stream, n_copies: int):
    """K1 or K7 through make_chain_scan / make_chain_tile on the int16 rows."""
    from waveformanalysis_tpu_torch.ops import chain_scan_cuda as csc
    from waveformanalysis_tpu_torch.ops import chain_tile_cuda as ctc

    n, L_w = w.shape
    w_e = [w + k for k in range(n_copies)]
    el = torch.full((n,), L_w, dtype=torch.int32, device=dev)
    bl = torch.full((n,), 1000.0, device=dev)
    pol = torch.ones(n, dtype=torch.int8, device=dev)
    step_fn = (csc.make_chain_scan if kern == "K1" else ctc.make_chain_tile)(cfg)
    prm = csc._params(cfg, n, L_w)
    if kern == "K1":
        lay = csc.chain_layout(L_w, w_e[0].data_ptr(), bool(cfg.use_derivative))
        label = f"K1 {n}x{L_w} bench config, {lay.path} path (R {lay.R}, {lay.rows} events a block)"
        library = csc._library
    else:
        lay = ctc.tile_layout(L_w, ctc.DEFAULT_TILE_ROWS)
        label = (f"K7 {n}x{L_w} bench config, {'float32' if lay.float_row else 'int16'} row, "
                 f"{lay.rows} events a block, {ctc.warps_per_sm(lay)} warps an SM")
        library = ctc._library
    vec = int(L_w % 8 == 0 and all(x.data_ptr() % 16 == 0 for x in w_e))

    def alone(lib):
        out = csc.chain_outputs(n, dev)
        ptrs = ctypes.byref(csc._Outs(*(out[key].data_ptr() for key, _ in csc._OUTS)))
        if kern == "K1":
            fn = csc._bind(lib, lay, prm)
            launch = lambda x: fn(x, el.data_ptr(), bl.data_ptr(), pol.data_ptr(), ptrs, stream)
        else:
            launch = lambda x: lib.wfa_chain_tile(x, el.data_ptr(), bl.data_ptr(), pol.data_ptr(),
                                                  ptrs, ctypes.byref(prm), lay.rows, vec,
                                                  int(lay.float_row), stream)

        def run(k):
            err = launch(w_e[k % n_copies].data_ptr())
            check(err == 0, f"{kern}: cudaError {err}")
        return run

    b = bound(nbytes(w, el, bl, pol) + 4 * csc._out_layout(n)[0], 20.0 * n * L_w)[0]
    return [Case(label, lambda k: step_fn(w_e[k % n_copies], el, bl, pol), alone, library,
                 f"{b:.4f} ms")]


def scan_cases(kern: str, w, dev, stream, n_copies: int):
    """K2-K4 through their wrappers on the event-major rows."""
    from waveformanalysis_tpu_torch.ops import chain_scan_cuda as csc
    from waveformanalysis_tpu_torch.ops import width_scan_cuda as wsc

    n, L_w = w.shape
    el = torch.full((n,), L_w, dtype=torch.int32, device=dev)
    sig = w.float() - 1000.0
    if kern == "K2":
        x_e = [sig + k for k in range(n_copies)]
        step = lambda k: csc.find_peaks_scan(x_e[k % n_copies], valid_length=el, **PEAKS_KW)
        prm = csc._PeaksParams(n=n, L=L_w, K=K, distance=2, height=80.0, prominence=50.0,
                               width=2.0, rel_height=0.5)
        lay = csc.row_layout(L_w, 4, x_e[0].data_ptr(), csc.PEAK_SLOT_BYTES)
        tables = lambda: csc._tables(csc._PEAKS_OUTS, n, K, dev)
        struct, library = csc._PeaksOut, csc._peaks_library
        ins, entry, ops = (el,), "wfa_peaks_scan", 8.0
    elif kern == "K3":
        thr = torch.full((n,), 10.0, device=dev)
        x_e = [sig + k for k in range(n_copies)]
        step = lambda k: csc.threshold_hits_scan(x_e[k % n_copies], thr, el, max_hits=K)
        prm = csc._HitsParams(n=n, L=L_w, K=K, left_extension=2, right_extension=2)
        lay = csc.row_layout(L_w, 4, x_e[0].data_ptr(), csc.HIT_SLOT_BYTES)
        tables = lambda: csc._tables(csc._HITS_OUTS, n, K, dev)
        struct, library = csc._HitsOut, csc._hits_library
        ins, entry, ops = (thr, el), "wfa_hits_scan", 4.0
    else:
        pos = csc.find_peaks_scan(sig, valid_length=el, **PEAKS_KW)["position"]
        blw = w.float()[:, :50].sum(dim=1) / 50
        x_e = [w + k for k in range(n_copies)]
        step = lambda k: wsc.width_crossings_scan(x_e[k % n_copies], blw, pos, *FRACS)
        prm = wsc._WidthParams(n=n, L=L_w, K=K, interpolation=1, rise_low=0.1, rise_high=0.9,
                               fall_high=0.9, fall_low=0.1)
        lay = csc.row_layout(L_w, 2, x_e[0].data_ptr())
        tables = lambda: {key: torch.empty((n, K), dtype=torch.int32 if key.endswith("_idx")
                                           else torch.float32, device=dev)
                          for key in wsc.OUT_KEYS}
        struct, library = wsc._WidthOut, wsc._library
        ins, entry, ops = (blw, pos), "wfa_width_scan", 2.0
    head = (0,) * (kern == "K4") + tuple(t.data_ptr() for t in ins)  # K4: int16 rows
    b = bound(nbytes(x_e[0], *ins, *tables().values()), ops * n * L_w)[0]

    def alone(lib):
        out = tables()  # in the C struct's field order
        ptrs = struct(*(t.data_ptr() for t in out.values()))
        fn = getattr(lib, entry)

        def run(k):
            err = fn(x_e[k % n_copies].data_ptr(), *head, ctypes.byref(ptrs), ctypes.byref(prm),
                     lay.rows, int(lay.staged), int(lay.vec), stream)
            check(err == 0, f"{kern}: cudaError {err}")
        return run

    return [Case(f"{kern} {n}x{L_w} K={K}", step, alone, library, f"{b:.4f} ms")]


def filter_cases(kern: str, w, dev, stream):
    """K5 (sosfiltfilt_cuda) or K6 (sosfilt_cuda on the reflected rows,
    forward and in reverse) with route B's design, two cold copies."""
    from waveformanalysis_tpu_torch.ops import filter_cuda as flc
    from waveformanalysis_tpu_torch.ops import filtering as flt

    n, L_w = w.shape
    sos = flt.design_butterworth_sos(*ROUTE_B_DESIGN)
    S, padlen = sos.shape[0], flt.sosfiltfilt_padlen(sos)
    coef = flc.coefficient_table(sos, dev)
    x_e = [w.float() + k for k in range(2)]
    cond = [flt.condition(x, sos) for x in x_e]
    if kern == "K5":
        prm = flc._SosParams(n=n, L=L_w, S=S, padlen=padlen)
        lay = flc.filter_layout(L_w, padlen)

        def alone(lib):
            out = torch.empty((n, L_w), device=dev)

            def run(k):
                m, d = cond[k % 2]
                err = lib.wfa_sosfiltfilt(x_e[k % 2].data_ptr(), m.data_ptr(), d.data_ptr(),
                                          coef.data_ptr(), out.data_ptr(), None,
                                          ctypes.byref(prm), lay.stride, stream)
                check(err == 0, f"K5: cudaError {err}")
            return run

        b = bound_at(nbytes(x_e[0]) * 2 + 8 * n, sosfiltfilt_ops(L_w, padlen, S) * n,
                     F32_NONFMA_OPS_PER_S)
        return [Case(f"K5 {n}x{L_w} route B design (S={S}, padlen {padlen}), tile {lay}",
                     lambda k: flc.sosfiltfilt_cuda(x_e[k % 2], sos), alone, flc._library,
                     f"{b[0]:.4f} ms by {b[1]}")]
    ext = [flt.reflect(x - m, padlen) for x, (m, _) in zip(x_e, cond)]  # (n, T) event-major
    T = ext[0].shape[1]
    prm = flc._SosParams(n=n, L=T, S=S, padlen=0)
    b = bound_at(2 * nbytes(ext[0]) + 8 * S * n, T * S * 9.0 * n, F32_NONFMA_OPS_PER_S)
    cases = []
    for reverse in (False, True):
        zi = flt._zi_times(sos, ext[0][:, -1 if reverse else 0])

        def alone(lib, zi=zi, reverse=reverse):
            y = torch.empty((n, T), device=dev)

            def run(k):
                err = lib.wfa_sosfilt(ext[k % 2].data_ptr(), zi.data_ptr(), coef.data_ptr(),
                                      y.data_ptr(), ctypes.byref(prm), int(reverse), stream)
                check(err == 0, f"K6: cudaError {err}")
            return run

        cases.append(Case(
            f"K6 {n}x{T} route B design (S={S}) {'reverse' if reverse else 'forward'}, "
            f"{flc.sosfilt_layout(S)}",
            lambda k, zi=zi, reverse=reverse: flc.sosfilt_cuda(ext[k % 2], sos, zi, reverse),
            alone, flc._library, f"{b[0]:.4f} ms by {b[1]}"))
    return cases


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="an earlier waveformanalysis_tpu_torch/csrc with this checkout's "
                         "C entries and structs")
    ap.add_argument("--kernels", default="K1",
                    help="comma-separated kernels to time: K1 (chain), K2 (find_peaks), "
                         "K3 (threshold hits), K4 (width crossings), K5 (zero-phase "
                         "Butterworth), K6 (one-direction Butterworth, forward and reverse), "
                         "K7 (tile chain)")
    ap.add_argument("--waves", choices=("bench", "two_pulses"), default="bench",
                    help="bench: bench.py's make_batch; two_pulses: two narrow pulses a row")
    args = ap.parse_args()
    kernels = args.kernels.split(",")
    check(set(kernels) <= set(SOURCES), f"--kernels takes {sorted(SOURCES)}")
    check(torch.cuda.is_available(), "needs a CUDA GPU")
    from bench import make_batch
    from waveformanalysis_tpu_torch.models.full_chain import ChainConfig

    if args.waves == "two_pulses":
        make_batch = two_pulse_batch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"kernel turns on {smi}, earlier csrc/ {args.parent}, {args.waves} waves", flush=True)
    names = sorted({SOURCES[kern] for kern in kernels})
    with ThreadPoolExecutor(max_workers=2 * len(names)) as pool:
        earlier = pool.map(partial(build_earlier, args.parent), names)
        new = pool.map(_build.build, names)
        sides = Sides(dict(zip(names, earlier)))
        list(new)
    dev = torch.device("cuda:0")
    stream = torch.cuda.current_stream(dev).cuda_stream
    cfg = ChainConfig(use_derivative=False, peak_height=80.0, peak_prominence=50.0,
                      peak_width=2.0)
    w_base = torch.from_numpy(make_batch(N_BASE, L, seed=0)).to(dev)
    shapes = [(N_BASE, L), (1_048_576, L)] + [(n, L_w) for L_w, n in LONG_ROWS]
    for n, L_w in shapes:
        if L_w == L:
            w = w_base.repeat(n // N_BASE, 1)
        else:
            w = torch.from_numpy(make_batch(8_192, L_w, seed=0)).to(dev).repeat(n // 8_192, 1)
        n_copies = 4 if n * L_w <= N_BASE * L else 2
        for kern in kernels:
            if L_w != L and kern not in ("K1", "K7"):
                continue
            if kern in ("K1", "K7"):
                cases = chain_cases(kern, w, cfg, dev, stream, n_copies)
            elif kern in ("K5", "K6"):
                cases = filter_cases(kern, w, dev, stream)
            else:
                cases = scan_cases(kern, w, dev, stream, n_copies)
            for case in cases:
                turns(sides, case)
            del cases
            torch.cuda.empty_cache()
        del w


if __name__ == "__main__":
    main()
