#!/usr/bin/env python3
"""Time the port's warp-per-event scan kernels in turns with an earlier
one-thread-per-event build of the same kernels, on one NVIDIA GPU.

    python3 scripts/scan_kernel_turns.py --parent DIR [--kernels K1,K3]

DIR holds an earlier version of ``waveformanalysis_tpu_torch/csrc`` whose
named kernels take the time-major ``(L, n)`` input, one thread per event,
with the parameter and output structs this checkout still uses: the
entries ``wfa_chain_scan(waves_t, el, bl, pol, out, params, stream)`` (K1),
``wfa_peaks_scan(x_t, vlen, out, params, stream)`` (K2),
``wfa_hits_scan(x_t, thr, vlen, out, params, stream)`` (K3) and
``wfa_width_scan(w_t, is_float, baseline, positions, out, params, stream)``
(K4). Their wrapper step is the transposing copy, the output allocation
and the launch, as that version's wrappers did.

On bench.py's waves (``make_batch(65536, 256, seed=0)``, repeated to
1,048,576 events), with bench.py's chain config (K1) and at K = 32 with the
route's settings (K2-K4), the script prints per kernel and size, as medians
of CUDA-event timings over fresh inputs:

- the kernels alone on cold copies (more bytes than the 50 MB L2 holds):
  the earlier kernel on time-major copies, this checkout's on event-major
  ones;
- the wrapper steps on the same cold copies: the earlier transposing copy,
  allocation and launch against this checkout's wrapper;

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

from chip_smoke import bound, check, median_ms, nbytes  # noqa: E402

K, L, N_BASE = 32, 256, 65_536
PEAKS_KW = dict(height=80.0, prominence=50.0, width=2.0, distance=2, max_peaks=K)
FRACS = (0.1, 0.9, 0.9, 0.1)
SOURCES = {"K1": "chain_scan", "K2": "peaks_scan", "K3": "hits_scan", "K4": "width_scan"}


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
            f"steps, earlier (copy + kernel) {s_old:.3f} / {s_old2:.3f} ms, new {s_new:.3f} / "
            f"{s_new2:.3f} ms")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="directory with the earlier time-major kernel sources")
    ap.add_argument("--kernels", default="K1,K2,K3,K4",
                    help="comma-separated kernels to time: K1 (chain), K2 (find_peaks), "
                         "K3 (threshold hits), K4 (width crossings)")
    args = ap.parse_args()
    kernels = args.kernels.split(",")
    check(set(kernels) <= set(SOURCES), f"--kernels takes {sorted(SOURCES)}")
    check(torch.cuda.is_available(), "needs a CUDA GPU")
    from bench import make_batch
    from waveformanalysis_tpu_torch.models.full_chain import ChainConfig
    from waveformanalysis_tpu_torch.ops import chain_scan_cuda as csc
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
        old["K1"].wfa_chain_scan.argtypes = [ctypes.c_void_p] * 7
    if "K2" in old:
        old["K2"].wfa_peaks_scan.argtypes = [ctypes.c_void_p] * 5
    if "K3" in old:
        old["K3"].wfa_hits_scan.argtypes = [ctypes.c_void_p] * 6
    if "K4" in old:
        old["K4"].wfa_width_scan.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
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
            w_t = [x.t().contiguous() for x in w_e]
            outs1 = csc.chain_outputs(size, dev)
            ptrs1 = csc._Outs(*(outs1[name].data_ptr() for name, _ in csc._OUTS))
            prm1 = csc._params(bench_cfg, size, L)
            lay1 = csc.row_layout(L, 2, w_e[0].data_ptr(), csc.CHAIN_SLOT_BYTES)
            new1 = csc._library()

            def old_k1(k):
                err = old["K1"].wfa_chain_scan(w_t[k % n_copies].data_ptr(), el.data_ptr(),
                                               bl.data_ptr(), pol.data_ptr(), ctypes.byref(ptrs1),
                                               ctypes.byref(prm1), stream)
                check(err == 0, f"earlier chain kernel: cudaError {err}")

            def new_k1(k):
                err = new1.wfa_chain_scan(w_e[k % n_copies].data_ptr(), el.data_ptr(),
                                          bl.data_ptr(), pol.data_ptr(), ctypes.byref(ptrs1),
                                          ctypes.byref(prm1), lay1.rows, int(lay1.vec), stream)
                check(err == 0, f"chain kernel: cudaError {err}")

            def old_step1(k):
                x_t = w_e[k % n_copies].t().contiguous()
                o = csc.chain_outputs(size, dev)
                p = csc._Outs(*(o[name].data_ptr() for name, _ in csc._OUTS))
                check(old["K1"].wfa_chain_scan(x_t.data_ptr(), el.data_ptr(), bl.data_ptr(),
                                               pol.data_ptr(), ctypes.byref(p),
                                               ctypes.byref(prm1), stream) == 0,
                      "earlier chain step")
                csc.with_overflow(o, bench_cfg)

            def new_step1(k):
                csc.chain_scan_cuda(w_e[k % n_copies], el, bl, pol, bench_cfg)

            b1 = bound(nbytes(w, el, bl, pol, *outs1.values()), 20.0 * size * L)[0]
            print(f"K1 {size}x{L} bench config: {in_turns(old_k1, new_k1, old_step1, new_step1)}"
                  f"; bound {b1:.4f} ms", flush=True)
            del w_e, w_t, outs1

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
        del w, sig
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
