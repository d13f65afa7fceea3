#!/usr/bin/env python3
"""Time the port's scan kernels in turns with an earlier build of the same
kernels, on one NVIDIA GPU.

    python3 scripts/scan_kernel_turns.py --parent DIR [--kernels K5,K7]
    python3 scripts/scan_kernel_turns.py --parent DIR --kernels K6

DIR holds an earlier version of ``waveformanalysis_tpu_torch/csrc`` whose
named kernels keep the parameter and output structs this checkout uses:

- K1, the chain kernel staged one warp per event on the event-major int16
  rows (PR 6 to PR 19): ``wfa_chain_scan(waves, el, bl, pol, out, params,
  rows, vec, stream)``; its step is the output allocation and the launch
  (the kernel counts the overflows), as this checkout's wrapper does. This
  checkout's K1 runs the path ``chain_layout`` picks (the register path at
  L = 256);
- K2-K4, one thread per event on the time-major ``(L, n)`` input: the
  entries ``wfa_peaks_scan(x_t, vlen, out, params, stream)`` (K2),
  ``wfa_hits_scan(x_t, thr, vlen, out, params, stream)`` (K3) and
  ``wfa_width_scan(w_t, is_float, baseline, positions, out, params,
  stream)`` (K4). Their wrapper step is the transposing copy, the output
  allocation and the launch, as that version's wrappers did;
- K5, one thread per event on the time-major mean-removed input:
  ``wfa_sosfiltfilt(x_t, coef, out_t, ends, params, stream)``; its step is
  that version's wrapper: the conditioning, the transposing subtraction,
  the launch and the transposing DC addition;
- K6, one thread per event on the time-major reflected rows:
  ``wfa_sosfilt(x_t, zi, coef, y_t, params, stream)``; its step is the
  transposing copy of the event-major rows (flipped first in reverse), the
  launch and the transposing copy back, as that version's wrappers did.
  This checkout's K6 runs on the event-major rows, forward and in reverse.
  Beside it, the zero-phase two-pass step (reflection, K6 forward, K6
  backward, the centre plus the DC response) of each version, and K5 alone
  against the same earlier build's K5, whose entry is this checkout's;
- K7, the tile chain on the event-major int16 rows:
  ``wfa_chain_tile(waves, el, bl, pol, out, params, rows, vec, stream)``;
  its step is the output allocation and the launch, as this checkout's
  wrapper does. This checkout's K7 is timed with each of its
  rows (``float_row`` 1: a float32 signal row beside the int16 one, the
  wrapper's choice at these lengths; 0: the int16 row alone, its long-row
  mode), with K1 alone and as a step beside them; then, with each row
  alone, at the longer L of ``LONG_ROWS``, where ``tile_layout`` picks
  the row by the warps an SM holds.

On bench.py's waves (``make_batch(65536, 256, seed=0)``, repeated to
1,048,576 events), with bench.py's chain config (K1, K7), at K = 32 with
the route's settings (K2-K4) and with route B's Butterworth design (K5),
the script prints per kernel and size, as medians of CUDA-event timings
over fresh inputs:

- the kernels alone on cold copies (more bytes than the 50 MB L2 holds):
  the earlier kernel on its layout, this checkout's on event-major rows
  (for K1, both outputs first compared: integers equal, the f32 gap);
- the wrapper steps on the same cold copies;

all in turns (earlier, new, new, earlier), in one process on one card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
import sys
from pathlib import Path

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

K, L, N_BASE = 32, 256, 65_536
PEAKS_KW = dict(height=80.0, prominence=50.0, width=2.0, distance=2, max_peaks=K)
FRACS = (0.1, 0.9, 0.9, 0.1)
SOURCES = {"K1": "chain_scan", "K2": "peaks_scan", "K3": "hits_scan", "K4": "width_scan",
           "K5": "sosfilt", "K6": "sosfilt", "K7": "chain_tile"}
ROUTE_B_DESIGN = (4, 0.002, 0.1, 0.5)  # chip_smoke.FILTER_DESIGNS["route_b"]
# K7's rows at longer L, 512 MB of int16 waves each: (L, events); tile_layout
# keeps the float row at 1,024 and drops it at 4,096 (8 warps a block)
LONG_ROWS = ((1_024, 262_144), (4_096, 65_536))


def build_earlier(parent: Path, name: str) -> ctypes.CDLL:
    """nvcc ``parent/<name>.cu`` with the port's flags into build/."""
    from waveformanalysis_tpu_torch.kernels._build import BUILD_DIR, NVCC_FLAGS, find_nvcc

    src = parent / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes() + (parent / "scan_common.cuh").read_bytes())
    so = BUILD_DIR / f"earlier_{name}_{key.hexdigest()[:16]}.so"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(so), str(src)],
                          capture_output=True, text=True)
    check(proc.returncode == 0, f"nvcc {src}: {proc.stderr[-2000:]}")
    return ctypes.CDLL(str(so))


def in_turns(old_k, new_k, old_step, new_step) -> str:
    """Alone and as steps, earlier / new / new / earlier; ms."""
    t_old, t_new = median_ms(old_k), median_ms(new_k)
    t_new2, t_old2 = median_ms(new_k), median_ms(old_k)
    s_old, s_new = median_ms(old_step), median_ms(new_step)
    s_new2, s_old2 = median_ms(new_step), median_ms(old_step)
    return (f"alone, earlier {t_old:.3f} / {t_old2:.3f} ms, new {t_new:.3f} / {t_new2:.3f} ms; "
            f"steps, earlier {s_old:.3f} / {s_old2:.3f} ms, new {s_new:.3f} / "
            f"{s_new2:.3f} ms")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="directory with the earlier time-major kernel sources")
    ap.add_argument("--kernels", default="K1",
                    help="comma-separated kernels to time: K1 (chain), K2 (find_peaks), "
                         "K3 (threshold hits), K4 (width crossings), K5 (zero-phase "
                         "Butterworth), K6 (one-direction Butterworth, with the two-pass "
                         "step and K5 beside it), K7 (tile chain)")
    args = ap.parse_args()
    kernels = args.kernels.split(",")
    check(set(kernels) <= set(SOURCES), f"--kernels takes {sorted(SOURCES)}")
    check(torch.cuda.is_available(), "needs a CUDA GPU")
    from bench import make_batch
    from waveformanalysis_tpu_torch.models.full_chain import ChainConfig
    from waveformanalysis_tpu_torch.ops import chain_scan_cuda as csc
    from waveformanalysis_tpu_torch.ops import chain_tile_cuda as ctc
    from waveformanalysis_tpu_torch.ops import filter_cuda as flc
    from waveformanalysis_tpu_torch.ops import filtering as flt
    from waveformanalysis_tpu_torch.ops import width_scan_cuda as wsc

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"scan kernel turns on {smi}", flush=True)
    dev = torch.device("cuda:0")
    stream = torch.cuda.current_stream(dev).cuda_stream
    old = {}
    for kern in kernels:
        old[kern] = build_earlier(args.parent, SOURCES[kern])
    if "K1" in old:
        old["K1"].wfa_chain_scan.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
    if "K2" in old:
        old["K2"].wfa_peaks_scan.argtypes = [ctypes.c_void_p] * 5
    if "K3" in old:
        old["K3"].wfa_hits_scan.argtypes = [ctypes.c_void_p] * 6
    if "K4" in old:
        old["K4"].wfa_width_scan.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
    if "K5" in old:
        old["K5"].wfa_sosfiltfilt.argtypes = [ctypes.c_void_p] * 6
    if "K6" in old:
        old["K6"].wfa_sosfilt.argtypes = [ctypes.c_void_p] * 6
        old["K6"].wfa_sosfiltfilt.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int,
                                                                      ctypes.c_void_p]
    if "K7" in old:
        old["K7"].wfa_chain_tile.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
    w_base = torch.from_numpy(make_batch(N_BASE, L, seed=0)).to(dev)
    bench_cfg = ChainConfig(use_derivative=False, peak_height=80.0, peak_prominence=50.0,
                            peak_width=2.0)

    for size in (N_BASE, 1_048_576):
        w = w_base.repeat(size // N_BASE, 1)
        sig = w.float() - 1000.0
        el = torch.full((size,), L, dtype=torch.int32, device=dev)
        n_copies = 4 if size == N_BASE else 2

        if "K1" in old:
            bl = torch.full((size,), 1000.0, device=dev)
            pol = torch.ones(size, dtype=torch.int8, device=dev)
            w_e = [w + k for k in range(n_copies)]
            vec = int(all(x.data_ptr() % 16 == 0 for x in w_e))
            prm1 = csc._params(bench_cfg, size, L)
            lay_old = csc.row_layout(L, 2, w_e[0].data_ptr(), csc.CHAIN_SLOT_BYTES)
            lay1 = csc.chain_layout(L, w_e[0].data_ptr(), bench_cfg.use_derivative)
            new1 = csc._library()

            def launch_old(k, ptrs):
                err = old["K1"].wfa_chain_scan(w_e[k % n_copies].data_ptr(), el.data_ptr(),
                                               bl.data_ptr(), pol.data_ptr(), ctypes.byref(ptrs),
                                               ctypes.byref(prm1), lay_old.rows, vec, stream)
                check(err == 0, f"earlier chain kernel: cudaError {err}")

            def launch_new(k, ptrs):
                err = csc.launch_chain(new1, lay1, w_e[k % n_copies].data_ptr(), el.data_ptr(),
                                       bl.data_ptr(), pol.data_ptr(), ptrs, prm1, stream)
                check(err == 0, f"chain kernel: cudaError {err}")

            outs1 = {}
            for name, launch in (("earlier", launch_old), ("new", launch_new)):
                outs1[name] = csc.chain_outputs(size, dev)
                launch(0, csc._Outs(*(outs1[name][key].data_ptr() for key, _ in csc._OUTS)))
            torch.cuda.synchronize()
            a, b = outs1["earlier"], outs1["new"]
            check(all(torch.equal(a[key], b[key]) for key in a if not a[key].is_floating_point()),
                  "K1: the new kernel's integer outputs differ from the earlier one's")
            f32_gap = max(float((a[key] - b[key]).abs().max()) for key in a
                          if a[key].is_floating_point())
            ptrs1 = csc._Outs(*(a[key].data_ptr() for key, _ in csc._OUTS))

            def step(launch):
                def run(k):
                    o = csc.chain_outputs(size, dev)
                    launch(k, csc._Outs(*(o[key].data_ptr() for key, _ in csc._OUTS)))
                return run

            b1 = bound(nbytes(w, el, bl, pol, *a.values()), 20.0 * size * L)[0]
            turns = in_turns(lambda k: launch_old(k, ptrs1), lambda k: launch_new(k, ptrs1),
                             step(launch_old), step(launch_new))
            staged = csc.ChainLayout("staged", 0, lay_old.rows, lay_old.smem_bytes, lay_old.vec)
            warps = [csc.chain_warps_per_sm(lay, bench_cfg.use_derivative)
                     for lay in (staged, lay1)]
            print(f"K1 {size}x{L} bench config: {turns}; bound {b1:.4f} ms; earlier staged, "
                  f"{lay_old.rows} events a block, {warps[0]} warps an SM (this checkout's "
                  f"staged path); new {lay1}, {warps[1]} warps an SM; integer outputs equal, "
                  f"f32 max |diff| {f32_gap:.3g}", flush=True)
            del w_e, outs1, a, b

        if "K2" in old:
            sig_e = [sig + k for k in range(n_copies)]
            sig_t = [s.t().contiguous() for s in sig_e]
            outs2 = csc._tables(csc._PEAKS_OUTS, size, K, dev)
            ptrs2 = csc._PeaksOut(*(outs2[name].data_ptr() for name, _ in csc._PEAKS_OUTS))
            prm2 = csc._PeaksParams(n=size, L=L, K=K, distance=2, height=80.0, prominence=50.0,
                                    width=2.0, rel_height=0.5)
            lay2 = csc.row_layout(L, 4, sig_e[0].data_ptr(), csc.PEAK_SLOT_BYTES)
            new2 = csc._peaks_library()

            def old_k2(k):
                err = old["K2"].wfa_peaks_scan(sig_t[k % n_copies].data_ptr(), el.data_ptr(),
                                               ctypes.byref(ptrs2), ctypes.byref(prm2), stream)
                check(err == 0, f"earlier peaks kernel: cudaError {err}")

            def new_k2(k):
                err = new2.wfa_peaks_scan(sig_e[k % n_copies].data_ptr(), el.data_ptr(),
                                          ctypes.byref(ptrs2), ctypes.byref(prm2), lay2.rows,
                                          int(lay2.staged), int(lay2.vec), stream)
                check(err == 0, f"peaks kernel: cudaError {err}")

            def old_step2(k):
                x_t = sig_e[k % n_copies].t().contiguous()
                o = csc._tables(csc._PEAKS_OUTS, size, K, dev)
                p = csc._PeaksOut(*(o[name].data_ptr() for name, _ in csc._PEAKS_OUTS))
                check(old["K2"].wfa_peaks_scan(x_t.data_ptr(), el.data_ptr(), ctypes.byref(p),
                                               ctypes.byref(prm2), stream) == 0,
                      "earlier peaks step")

            def new_step2(k):
                csc.find_peaks_scan(sig_e[k % n_copies], valid_length=el, **PEAKS_KW)

            b2 = bound(nbytes(sig, el, *outs2.values()), 8.0 * size * L)[0]
            print(f"K2 {size}x{L} K={K}: {in_turns(old_k2, new_k2, old_step2, new_step2)}; "
                  f"bound {b2:.4f} ms", flush=True)
            del sig_t, sig_e, outs2

        if "K3" in old:
            thr = torch.full((size,), 10.0, device=dev)
            sig_e = [sig + k for k in range(n_copies)]
            sig_t = [s.t().contiguous() for s in sig_e]
            outs3 = csc._tables(csc._HITS_OUTS, size, K, dev)
            ptrs3 = csc._HitsOut(*(outs3[name].data_ptr() for name, _ in csc._HITS_OUTS))
            prm3 = csc._HitsParams(n=size, L=L, K=K, left_extension=2, right_extension=2)
            lay3 = csc.row_layout(L, 4, sig_e[0].data_ptr(), csc.HIT_SLOT_BYTES)
            new3 = csc._hits_library()

            def old_k3(k):
                err = old["K3"].wfa_hits_scan(sig_t[k % n_copies].data_ptr(), thr.data_ptr(),
                                              el.data_ptr(), ctypes.byref(ptrs3),
                                              ctypes.byref(prm3), stream)
                check(err == 0, f"earlier hits kernel: cudaError {err}")

            def new_k3(k):
                err = new3.wfa_hits_scan(sig_e[k % n_copies].data_ptr(), thr.data_ptr(),
                                         el.data_ptr(), ctypes.byref(ptrs3), ctypes.byref(prm3),
                                         lay3.rows, int(lay3.staged), int(lay3.vec), stream)
                check(err == 0, f"hits kernel: cudaError {err}")

            def old_step3(k):
                x_t = sig_e[k % n_copies].t().contiguous()
                o = csc._tables(csc._HITS_OUTS, size, K, dev)
                p = csc._HitsOut(*(o[name].data_ptr() for name, _ in csc._HITS_OUTS))
                check(old["K3"].wfa_hits_scan(x_t.data_ptr(), thr.data_ptr(), el.data_ptr(),
                                              ctypes.byref(p), ctypes.byref(prm3), stream) == 0,
                      "earlier hits step")

            def new_step3(k):
                csc.threshold_hits_scan(sig_e[k % n_copies], thr, el, max_hits=K)

            b3 = bound(nbytes(sig, thr, el, *outs3.values()), 4.0 * size * L)[0]
            print(f"K3 {size}x{L} K={K}: {in_turns(old_k3, new_k3, old_step3, new_step3)}; "
                  f"bound {b3:.4f} ms; runs {int(outs3['valid'].sum())}", flush=True)
            del sig_t, sig_e, outs3

        if "K4" in old:
            pos = csc.find_peaks_scan(sig, valid_length=el, **PEAKS_KW)["position"]
            blw = w.float()[:, :50].sum(dim=1) / 50
            w_e = [w + k for k in range(n_copies)]
            w_t = [x.t().contiguous() for x in w_e]
            outs4 = {key: torch.empty((size, K), dtype=torch.int32 if key.endswith("_idx")
                                      else torch.float32, device=dev) for key in wsc.OUT_KEYS}
            ptrs4 = wsc._WidthOut(*(outs4[key].data_ptr() for key in wsc.OUT_KEYS))
            prm4 = wsc._WidthParams(n=size, L=L, K=K, interpolation=1, rise_low=0.1,
                                    rise_high=0.9, fall_high=0.9, fall_low=0.1)
            lay4 = csc.row_layout(L, 2, w_e[0].data_ptr())
            new4 = wsc._library()

            def old_k4(k):
                err = old["K4"].wfa_width_scan(w_t[k % n_copies].data_ptr(), 0, blw.data_ptr(),
                                               pos.data_ptr(), ctypes.byref(ptrs4),
                                               ctypes.byref(prm4), stream)
                check(err == 0, f"earlier width kernel: cudaError {err}")

            def new_k4(k):
                err = new4.wfa_width_scan(w_e[k % n_copies].data_ptr(), 0, blw.data_ptr(),
                                          pos.data_ptr(), ctypes.byref(ptrs4), ctypes.byref(prm4),
                                          lay4.rows, int(lay4.staged), int(lay4.vec), stream)
                check(err == 0, f"width kernel: cudaError {err}")

            def old_step4(k):
                x_t = w_e[k % n_copies].t().contiguous()
                o = {key: torch.empty((size, K), dtype=torch.int32 if key.endswith("_idx")
                                      else torch.float32, device=dev) for key in wsc.OUT_KEYS}
                p = wsc._WidthOut(*(o[key].data_ptr() for key in wsc.OUT_KEYS))
                check(old["K4"].wfa_width_scan(x_t.data_ptr(), 0, blw.data_ptr(), pos.data_ptr(),
                                               ctypes.byref(p), ctypes.byref(prm4), stream) == 0,
                      "earlier width step")

            def new_step4(k):
                wsc.width_crossings_scan(w_e[k % n_copies], blw, pos, *FRACS)

            b4 = bound(nbytes(w, blw, pos, *outs4.values()), 2.0 * size * L)[0]
            print(f"K4 {size}x{L} K={K} int16: {in_turns(old_k4, new_k4, old_step4, new_step4)}"
                  f"; bound {b4:.4f} ms; occupied slots {int((pos >= 0).sum())}", flush=True)
            del w_e, w_t, outs4, pos
        if "K7" in old:
            bl = torch.full((size,), 1000.0, device=dev)
            pol = torch.ones(size, dtype=torch.int8, device=dev)
            w_e = [w + k for k in range(n_copies)]
            vec = int(all(x.data_ptr() % 16 == 0 for x in w_e))
            prm7 = csc._params(bench_cfg, size, L)
            new7 = ctc._library()
            rows = {"earlier": ctc.DEFAULT_TILE_ROWS}
            for name, fr in (("int16 row", False), ("float row", True)):
                rows[name] = min(ctc.DEFAULT_TILE_ROWS,
                                 csc.SMEM_BYTES // ctc.event_smem_bytes(L, fr))

            def launch7(name, w_ptr, ptrs):
                if name == "earlier":
                    return old["K7"].wfa_chain_tile(w_ptr, el.data_ptr(), bl.data_ptr(),
                                                    pol.data_ptr(), ctypes.byref(ptrs),
                                                    ctypes.byref(prm7), rows[name], vec, stream)
                return new7.wfa_chain_tile(w_ptr, el.data_ptr(), bl.data_ptr(), pol.data_ptr(),
                                           ctypes.byref(ptrs), ctypes.byref(prm7), rows[name],
                                           vec, int(name == "float row"), stream)
            lay1 = csc.chain_layout(L, w_e[0].data_ptr(), bench_cfg.use_derivative)
            new1 = csc._library()

            def tile_step(name):
                def run(k):
                    o = csc.chain_outputs(size, dev)
                    p = csc._Outs(*(o[key].data_ptr() for key, _ in csc._OUTS))
                    err = launch7(name, w_e[k % n_copies].data_ptr(), p)
                    check(err == 0, f"{name} tile chain: cudaError {err}")
                return run

            outs7 = csc.chain_outputs(size, dev)
            ptrs7 = csc._Outs(*(outs7[key].data_ptr() for key, _ in csc._OUTS))

            def tile_alone(name):
                def run(k):
                    err = launch7(name, w_e[k % n_copies].data_ptr(), ptrs7)
                    check(err == 0, f"{name} tile chain: cudaError {err}")
                return run

            def k1_alone(k):
                err = csc.launch_chain(new1, lay1, w_e[k % n_copies].data_ptr(), el.data_ptr(),
                                       bl.data_ptr(), pol.data_ptr(), ptrs7, prm7, stream)
                check(err == 0, f"chain kernel: cudaError {err}")

            order = ("earlier", "int16 row", "float row")
            alone = {name: [] for name in order + ("K1",)}
            steps = {name: [] for name in order + ("K1",)}
            for name in order + ("K1",) + tuple(reversed(order)):
                alone[name].append(median_ms(k1_alone if name == "K1" else tile_alone(name)))
            for name in order + ("K1",) + tuple(reversed(order)):
                steps[name].append(median_ms(
                    (lambda k: csc.chain_scan_cuda(w_e[k % n_copies], el, bl, pol, bench_cfg))
                    if name == "K1" else tile_step(name)))
            b7 = bound(nbytes(w, el, bl, pol, *outs7.values()), 20.0 * size * L)[0]
            print(f"K7 {size}x{L} bench config, in turns (earlier, int16 row, float row, K1, "
                  f"float row, int16 row, earlier), ms: alone "
                  + "; ".join(f"{name} {' / '.join(f'{t:.3f}' for t in alone[name])}"
                              for name in alone)
                  + "; steps " + "; ".join(f"{name} {' / '.join(f'{t:.3f}' for t in steps[name])}"
                                          for name in steps)
                  + f"; rows per block {rows}; bound {b7:.4f} ms", flush=True)
            del w_e, outs7

        if "K5" in old:
            sos = flt.design_butterworth_sos(*ROUTE_B_DESIGN)
            S, padlen = sos.shape[0], flt.sosfiltfilt_padlen(sos)
            coef = flc.coefficient_table(sos, dev)
            x_e = [w.float() + k for k in range(2)]  # cold event-major copies
            cond = [flt.condition(x, sos) for x in x_e]
            xc_t = [(x - m).t().contiguous() for x, (m, _) in zip(x_e, cond)]
            out_t = torch.empty((L, size), device=dev)
            ends = torch.empty((2 * padlen, size), device=dev)
            out = torch.empty((size, L), device=dev)
            prm5 = flc._SosParams(n=size, L=L, S=S, padlen=padlen)
            lay5 = flc.filter_layout(L, padlen)
            new5 = flc._library()

            def old_k5(k):
                err = old["K5"].wfa_sosfiltfilt(xc_t[k % 2].data_ptr(), coef.data_ptr(),
                                                out_t.data_ptr(), ends.data_ptr(),
                                                ctypes.byref(prm5), stream)
                check(err == 0, f"earlier sosfiltfilt kernel: cudaError {err}")

            def new_k5(k):
                m, d = cond[k % 2]
                err = new5.wfa_sosfiltfilt(x_e[k % 2].data_ptr(), m.data_ptr(), d.data_ptr(),
                                           coef.data_ptr(), out.data_ptr(), None,
                                           ctypes.byref(prm5), lay5.stride, stream)
                check(err == 0, f"sosfiltfilt kernel: cudaError {err}")

            def old_step5(k):
                x = x_e[k % 2]
                m, d = flt.condition(x, sos)
                xt = torch.sub(x.t(), m.t(), out=torch.empty((L, size), device=dev))
                ot = torch.empty((L, size), device=dev)
                en = torch.empty((2 * padlen, size), device=dev)
                check(old["K5"].wfa_sosfiltfilt(xt.data_ptr(), coef.data_ptr(), ot.data_ptr(),
                                                en.data_ptr(), ctypes.byref(prm5), stream) == 0,
                      "earlier sosfiltfilt step")
                torch.add(ot.t(), d, out=torch.empty((size, L), device=dev))

            def new_step5(k):
                flc.sosfiltfilt_cuda(x_e[k % 2], sos)

            b5 = bound_at(nbytes(x_e[0], out) + 8 * size, sosfiltfilt_ops(L, padlen, S) * size,
                          F32_NONFMA_OPS_PER_S)
            print(f"K5 {size}x{L} route B design (S={S}, padlen {padlen}): "
                  f"{in_turns(old_k5, new_k5, old_step5, new_step5)}; bound {b5[0]:.4f} ms by "
                  f"{b5[1]}; tile {lay5}", flush=True)
            del x_e, cond, xc_t, out_t, ends, out

        if "K6" in old:
            sosfilt_turns(old["K6"], flc, flt, w, size, dev, stream)

        del w, sig
        torch.cuda.empty_cache()

    if "K7" in old:
        for L_long, n_long in LONG_ROWS:
            long_row_turns(make_batch, ctc, csc, bench_cfg, dev, stream, L_long, n_long)


def sosfilt_turns(old_lib, flc, flt, w, size: int, dev, stream) -> None:
    """K6 alone, forward and in reverse, the two-pass step and K5 alone, each
    against the earlier build, in turns, on route B's design (reflected rows
    of L + 2 padlen = 310 samples)."""
    sos = flt.design_butterworth_sos(*ROUTE_B_DESIGN)
    S, padlen = sos.shape[0], flt.sosfiltfilt_padlen(sos)
    T = L + 2 * padlen
    coef = flc.coefficient_table(sos, dev)
    x_e = [w.float() + k for k in range(2)]  # cold event-major copies
    cond = [flt.condition(x, sos) for x in x_e]
    xc = [x - m for x, (m, _) in zip(x_e, cond)]
    ext = [flt.reflect(x, padlen) for x in xc]  # event-major (n, T)
    ext_t = [e.t().contiguous() for e in ext]  # the earlier kernel's time-major input
    rev_t = [e.flip(0).contiguous() for e in ext_t]  # ... and its reversed input
    zi = {False: flt._zi_times(sos, ext[0][:, 0]), True: flt._zi_times(sos, ext[0][:, -1])}
    y = torch.empty((size, T), device=dev)
    y_t = torch.empty((T, size), device=dev)
    prm = flc._SosParams(n=size, L=T, S=S, padlen=0)
    new = flc._library()

    def old_k6(x_t, z, out):
        check(old_lib.wfa_sosfilt(x_t.data_ptr(), z.data_ptr(), coef.data_ptr(),
                                  out.data_ptr(), ctypes.byref(prm), stream) == 0,
              "earlier sosfilt kernel")

    def new_k6(x, z, out, reverse):
        check(new.wfa_sosfilt(x.data_ptr(), z.data_ptr(), coef.data_ptr(), out.data_ptr(),
                              ctypes.byref(prm), int(reverse), stream) == 0, "sosfilt kernel")

    # the versions agree bit for bit before they are timed
    for reverse in (False, True):
        old_k6(rev_t[0] if reverse else ext_t[0], zi[reverse], y_t)
        ref = y_t.flip(0).t() if reverse else y_t.t()
        new_k6(ext[0], zi[reverse], y, reverse)
        torch.cuda.synchronize()
        check(torch.equal(y, ref), f"K6 reverse={reverse}: the new kernel differs from the "
                                   f"earlier one")

    def old_alone(reverse):
        src = rev_t if reverse else ext_t
        return lambda k: old_k6(src[k % 2], zi[reverse], y_t)

    def new_alone(reverse):
        return lambda k: new_k6(ext[k % 2], zi[reverse], y, reverse)

    def old_step(reverse):
        def run(k):
            x = ext[k % 2]
            x_t = (x.t().flip(0) if reverse else x.t()).contiguous()
            out_t = torch.empty((T, size), device=dev)
            old_k6(x_t, zi[reverse], out_t)
            (out_t.flip(0) if reverse else out_t).t().contiguous()
        return run

    def new_step(reverse):
        return lambda k: flc.sosfilt_cuda(ext[k % 2], sos, zi[reverse], reverse=reverse)

    b6 = bound_at(nbytes(ext[0], zi[False], y), T * S * 9.0 * size, F32_NONFMA_OPS_PER_S)
    for reverse in (False, True):
        tag = "reverse" if reverse else "forward"
        turns = in_turns(old_alone(reverse), new_alone(reverse), old_step(reverse),
                         new_step(reverse))
        print(f"K6 {size}x{T} route B design (S={S}) {tag}: {turns}; bound {b6[0]:.4f} ms by "
              f"{b6[1]}; {flc.sosfilt_layout(S)}", flush=True)

    def old_two_pass(k):
        x = xc[k % 2]
        left = 2.0 * x[:, :1] - x[:, 1:padlen + 1].flip(1)
        right = 2.0 * x[:, -1:] - x[:, -padlen - 1:-1].flip(1)
        e_t = torch.cat([left, x, right], dim=1).t().contiguous()
        y1 = torch.empty_like(e_t)
        old_k6(e_t, flt._zi_times(sos, e_t[0]), y1)
        y_rev = y1.flip(0)
        y2 = torch.empty_like(e_t)
        old_k6(y_rev, flt._zi_times(sos, y_rev[0]), y2)
        return (y2.flip(0)[padlen:padlen + L].t() + cond[k % 2][1]).contiguous()

    def new_two_pass(k):
        return flc._two_pass(xc[k % 2], cond[k % 2][1], sos, padlen)

    check(torch.equal(old_two_pass(0), new_two_pass(0)), "two-pass steps differ")
    t = [median_ms(f) for f in (old_two_pass, new_two_pass, new_two_pass, old_two_pass)]
    print(f"two-pass step {size}x{L} route B design, in turns (earlier, new, new, earlier), "
          f"ms: earlier {t[0]:.3f} / {t[3]:.3f}, new {t[1]:.3f} / {t[2]:.3f}", flush=True)

    # K5 alone: this checkout's kernel against the earlier build's
    out = torch.empty((size, L), device=dev)
    prm5 = flc._SosParams(n=size, L=L, S=S, padlen=padlen)
    lay5 = flc.filter_layout(L, padlen)

    def k5(lib):
        def run(k):
            m, d = cond[k % 2]
            check(lib.wfa_sosfiltfilt(x_e[k % 2].data_ptr(), m.data_ptr(), d.data_ptr(),
                                      coef.data_ptr(), out.data_ptr(), None, ctypes.byref(prm5),
                                      lay5.stride, stream) == 0, "sosfiltfilt kernel")
        return run

    k5(old_lib)(0)
    ref5 = out.clone()
    k5(new)(0)
    torch.cuda.synchronize()
    check(torch.equal(out, ref5), "K5: the new build differs from the earlier one")
    t = [median_ms(k5(lib)) for lib in (old_lib, new, new, old_lib)]
    b5 = bound_at(nbytes(x_e[0], out) + 8 * size, sosfiltfilt_ops(L, padlen, S) * size,
                  F32_NONFMA_OPS_PER_S)
    print(f"K5 {size}x{L} route B design alone, in turns (earlier, new, new, earlier), ms: "
          f"earlier {t[0]:.3f} / {t[3]:.3f}, new {t[1]:.3f} / {t[2]:.3f}; bound "
          f"{b5[0]:.4f} ms by {b5[1]}", flush=True)


def long_row_turns(make_batch, ctc, csc, cfg, dev, stream, L_long: int, n: int) -> None:
    """This checkout's K7 with each of its rows at a longer L, in turns
    (int16 row, float row, float row, int16 row), each with the events per
    block tile_layout gives it, beside the warps an SM holds and the row
    tile_layout picks."""
    base = torch.from_numpy(make_batch(8_192, L_long, seed=0)).to(dev)
    w_e = [base.repeat(n // 8_192, 1) + k for k in range(2)]
    el = torch.full((n,), L_long, dtype=torch.int32, device=dev)
    bl = torch.full((n,), 1000.0, device=dev)
    pol = torch.ones(n, dtype=torch.int8, device=dev)
    vec = int(L_long % 8 == 0 and all(x.data_ptr() % 16 == 0 for x in w_e))
    prm = csc._params(cfg, n, L_long)
    outs = csc.chain_outputs(n, dev)
    ptrs = csc._Outs(*(outs[key].data_ptr() for key, _ in csc._OUTS))
    lib = ctc._library()
    lays = {name: ctc._layout(L_long, ctc.DEFAULT_TILE_ROWS, fr)
            for name, fr in (("int16 row", False), ("float row", True))}
    res = {}
    for name, lay in lays.items():  # the two rows agree on every output
        check(lib.wfa_chain_tile(w_e[0].data_ptr(), el.data_ptr(), bl.data_ptr(),
                                 pol.data_ptr(), ctypes.byref(ptrs), ctypes.byref(prm), lay.rows,
                                 vec, int(lay.float_row), stream) == 0, f"K7 {name}")
        res[name] = {key: v.clone() for key, v in outs.items()}
    a, b = res["int16 row"], res["float row"]
    check(all(torch.equal(a[key], b[key]) for key in outs if not a[key].is_floating_point()),
          f"K7 at L = {L_long}: the two rows disagree on an integer output")
    f32_diff = max(float((a[key] - b[key]).abs().max()) for key in outs
                   if a[key].is_floating_point() and a[key].numel())

    def alone(name):
        lay = lays[name]

        def run(k):
            err = lib.wfa_chain_tile(w_e[k % 2].data_ptr(), el.data_ptr(), bl.data_ptr(),
                                     pol.data_ptr(), ctypes.byref(ptrs), ctypes.byref(prm),
                                     lay.rows, vec, int(lay.float_row), stream)
            check(err == 0, f"K7 {name}: cudaError {err}")
        return run

    times = {name: [] for name in lays}
    for name in ("int16 row", "float row", "float row", "int16 row"):
        times[name].append(median_ms(alone(name)))
    picked = ctc.tile_layout(L_long, ctc.DEFAULT_TILE_ROWS)
    print(f"K7 {n}x{L_long} bench-shaped waves, alone in turns (int16 row, float row, float "
          f"row, int16 row), ms: "
          + "; ".join(f"{name} {' / '.join(f'{t:.3f}' for t in times[name])} ({lay.rows} "
                      f"events a block, {lay.smem_bytes} B, {ctc.warps_per_sm(lay)} warps an "
                      f"SM)" for name, lay in lays.items())
          + f"; integer outputs equal, f32 max |diff| {f32_diff:.3g}; tile_layout picks the "
          f"{'float' if picked.float_row else 'int16'} row", flush=True)


if __name__ == "__main__":
    main()
